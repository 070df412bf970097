"""Host spans of the SLAM frame and the training step, and the profiler
switch (port of deeppointmap_tpu/utils/timer.py).

`scope(name, arg)` opens a frame or a step on the calling thread: a tally
{span name: seconds} that the caller hands to its own sink when the scope
closes (`SlamSystem.step` to the ResultLogger, `Trainer.train_one_epoch`
to the step's steps.jsonl row). `span(name)` times a section inside it:
it adds its host seconds (`time.perf_counter`) to the tally of the scope
open on its thread, under its name, summed over the scope. A span on a
thread with no scope open adds nothing, so the prefetch thread and the
pipelined mode's stage threads accumulate nothing.

`add(tally)` hands a tally made elsewhere (another thread's scope, the
training batch producer's) to the scope open on the calling thread.

Totals are inclusive: a span's seconds include those of every span opened
inside it. A parent's self time is its total minus its children's totals
(`slam.odometry` holds `engine.wait` and `kabsch.solve`).

Only while a profiler records (`torch.profiler`, the benchmark's traced
runs, `--profile`) do scopes and spans also open a profiler range,
`dpm.<name>` (a scope's carries its frame or step number; a span in a
scope follows what the scope read when it opened): the range lands on
the clock of the device activity in the same trace, so that an idle gap
can be put down to what the host was doing. With no profiler the range is
never entered: it costs ~10 us a call even then.

`device_trace` captures a `torch.profiler` trace around a code section and
writes it as a Chrome trace (viewable in Perfetto or chrome://tracing),
where the JAX package writes a `jax.profiler` trace; `--profile` of the
CLI turns it on.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Optional

import torch

#: file name of the Chrome trace that `device_trace` writes
TRACE_FILE = "trace.json"
#: prefix of the profiler ranges that spans and scopes open
RANGE_PREFIX = "dpm."

_clock = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled


#: the scope open in the calling thread's context (a new thread starts
#: with none); a context variable, as it reads faster than a thread-local
_SCOPE: ContextVar[Optional["scope"]] = ContextVar("dpm_scope", default=None)
#: (span, range) of the spans open outside a scope while a profiler records
_OUTSIDE: ContextVar[list] = ContextVar("dpm_outside_ranges")


def _open_range(name: str, arg):
    rf = torch.profiler.record_function(
        RANGE_PREFIX + name, None if arg is None else str(arg))
    rf.__enter__()
    return rf


class scope:
    """`with scope("slam.frame", 12) as tally: ...`: the calling thread's
    spans add their seconds to `tally` until the block ends. Whether a
    profiler records is read once, when the scope opens: it decides for
    the scope's range and its spans'. A scope opened inside another
    replaces it on the thread until it closes; spans close inside the
    scope they opened in."""

    __slots__ = ("name", "arg", "tally", "profiling", "starts", "ranges",
                 "_token", "_range")

    def __init__(self, name: str, arg=None):
        self.name, self.arg = name, arg
        self.tally: Dict[str, float] = {}
        self.starts: list = []   # clock reads of the spans open in it
        self.ranges: list = []   # and their profiler ranges

    def __enter__(self) -> Dict[str, float]:
        self._token = _SCOPE.set(self)
        self.profiling = _profiling()
        self._range = _open_range(self.name, self.arg) if self.profiling \
            else None
        return self.tally

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        _SCOPE.reset(self._token)
        return False


class span:
    """`with span("engine.wait"): ...`: the block's host seconds go to the
    tally of the scope open on this thread (none: nothing). A span holds
    no state of its own (the scope and the thread do), so one object may
    serve a site on every thread: a module keeps its spans as constants,
    and with no profiler recording a span then costs two Python calls, a
    clock read at each end and a dict update."""

    __slots__ = ("name", "arg")

    def __init__(self, name: str, arg=None):
        self.name, self.arg = name, arg

    def __enter__(self) -> "span":
        sc = _SCOPE.get()
        if sc is None:
            if _profiling():
                opened = _OUTSIDE.get(None)
                if opened is None:
                    opened = []
                    _OUTSIDE.set(opened)
                opened.append((self, _open_range(self.name, self.arg)))
            return self
        if sc.profiling:
            sc.ranges.append(_open_range(self.name, self.arg))
        sc.starts.append(_clock())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        sc = _SCOPE.get()
        if sc is not None:
            dt = _clock() - sc.starts.pop()
            tally, name = sc.tally, self.name
            tally[name] = tally.get(name, 0.0) + dt
            if sc.profiling:
                sc.ranges.pop().__exit__(exc_type, exc, tb)
            return False
        opened = _OUTSIDE.get(None)
        if opened and opened[-1][0] is self:
            opened.pop()[1].__exit__(exc_type, exc, tb)
        return False


def add(tally: Dict[str, float]) -> None:
    """Add the seconds of `tally` (spans timed on another thread or in
    another process) to the scope open on this thread, under their names
    (no scope: nothing)."""
    sc = _SCOPE.get()
    if sc is not None:
        for name, seconds in tally.items():
            sc.tally[name] = sc.tally.get(name, 0.0) + seconds


@contextmanager
def device_trace(log_dir: Optional[str], cuda: bool = False):
    """Profile the host (and, with `cuda`, the GPU's kernels) around a
    code section and write `log_dir/trace.json`; a no-op when `log_dir` is
    falsy. Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
