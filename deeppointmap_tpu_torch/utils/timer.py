"""Wall-clock section timing and the profiler switch (port of
deeppointmap_tpu/utils/timer.py).

`Timer` is the reference's hand-rolled section timer (reference:
utils/timer.py:4-23). `device_trace` captures a `torch.profiler` trace
around a code section and writes it as a Chrome trace (viewable in
Perfetto or chrome://tracing), where the JAX package writes a
`jax.profiler` trace; `--profile` of the CLI turns it on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

#: file name of the Chrome trace that `device_trace` writes
TRACE_FILE = "trace.json"


class Timer:
    """Named section timer: `with timer.record("encode"): ...`."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def record(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def mean(self, name: str) -> float:
        ts = self.times.get(name, [])
        return sum(ts) / len(ts) if ts else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.times}

    def reset(self) -> None:
        self.times.clear()


@contextlib.contextmanager
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
