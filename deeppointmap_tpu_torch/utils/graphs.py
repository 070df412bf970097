"""CUDA graphs for the engine's device programs: extraction
(`slam/engine.InferenceEngine._extract_impl`) and registration
(`models/decoder.Decoder.registration`).

A program is a function of tensors (and host ints) that returns a tuple of
tensors and makes no host sync. `Graphs` runs it on the card from a CUDA
graph, so that its few hundred kernels cost one launch of the host's:

- Key: the program's own key (its static arguments and the switches
  that change its kernels), the arguments' shapes and dtypes, and the
  current CUDA stream.
- A key's first call runs eagerly. Its second warms the program up on the
  object's capture stream, captures it there, then replays it; later calls
  only replay. A shape seen once costs no capture.
- An object's graphs share one memory pool: a graph captured later may
  keep its static outputs in scratch that an earlier graph writes when it
  replays. So one lock holds each call from the copies in to the copies
  out (and each capture), and each replay waits on the device for the
  copies out of the one before it, on whatever stream or thread that ran:
  the pipelined mode's stage threads and the agents of one process all
  replay on the default stream, and no two replays of an object overlap.
- A replay copies the arguments into the graph's static inputs (a host
  int becomes a device scalar, filled in place), replays on the current
  stream, and returns fresh copies of the static outputs: a caller may
  keep what it was given across later replays.
- The hand-written kernels' launch counts (`kernels.py`) count a replayed
  kernel: a capture's launches are recorded, and added at each replay.
- Each call counts as `engine.graph.replay` or `engine.graph.eager`
  (`utils/timer.count`): eager is a first sighting, a capture, or a call
  the graphs do not take (CPU tensors, outside inference mode, a capture
  underway).

Nothing here changes what a program computes: a replay is the eager run's
kernels on the same inputs.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple

import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.utils import timer

REPLAY = "engine.graph.replay"
EAGER = "engine.graph.eager"


def _signature(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype
    return None if a is None else int


def _engaged(args) -> bool:
    """Whether the graphs take a call: every tensor on a card, inference
    mode (the engine's entry points; a graph's buffers are inference
    tensors), no capture underway on this thread's stream."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return bool(tensors) and all(t.is_cuda for t in tensors) \
        and torch.is_inference_mode_enabled() \
        and not torch.cuda.is_current_stream_capturing()


class _Entry:
    __slots__ = ("graph", "inputs", "outputs", "launched")

    def __init__(self):
        self.graph = None
        self.inputs = self.outputs = self.launched = None


class Graphs:
    """The CUDA graphs of one object's programs (an engine's, a
    decoder's). `graphs(fn, args, key)` -> fn(*args), from a graph where
    it can."""

    def __init__(self):
        self._entries: Dict[tuple, _Entry] = {}
        #: on first capture: the memory pool, the capture stream (one, so
        #: that its cuBLAS workspace is made once) and the event recorded
        #: after each replay's copies out
        self._pool = self._side = self._done = None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return sum(e.graph is not None for e in self._entries.values())

    def __call__(self, fn: Callable, args: tuple, key: tuple = ()
                 ) -> Tuple[torch.Tensor, ...]:
        if not _engaged(args):
            timer.count(EAGER)
            return fn(*args)
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        stream = torch.cuda.current_stream(dev)
        full = (key, dev.index, stream.cuda_stream,
                tuple(_signature(a) for a in args))
        with self._lock:
            entry = self._entries.get(full)
            if entry is not None:
                captured = entry.graph is not None
                if not captured:
                    self._capture(entry, fn, args, stream)
                timer.count(REPLAY if captured else EAGER)
                return self._replay(entry, args, stream)
            self._entries[full] = _Entry()
        timer.count(EAGER)
        return fn(*args)

    @staticmethod
    def _fill(inputs, args) -> None:
        for buf, a in zip(inputs, args):
            if isinstance(a, torch.Tensor):
                buf.copy_(a)
            elif a is not None:
                buf.fill_(int(a))

    def _capture(self, entry: _Entry, fn, args, stream) -> None:
        """Under the lock: warm `fn` up on the capture stream, on static
        inputs filled from `args`, and capture it there into `entry`. The
        warm-up's kernel launches are not counted: the call counts its
        replay's."""
        dev = stream.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(dev)
            self._done = torch.cuda.Event()
        inputs = [a if a is None else
                  torch.empty_like(a) if isinstance(a, torch.Tensor)
                  else torch.empty((), dtype=torch.int64, device=dev)
                  for a in args]
        self._fill(inputs, args)
        side = self._side
        side.wait_stream(stream)
        side.wait_event(self._done)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with kernels.recording():
                fn(*inputs)
            with kernels.recording() as launched:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = fn(*inputs)
                finally:
                    graph.capture_end()
        stream.wait_stream(side)
        entry.inputs, entry.outputs = inputs, tuple(outputs)
        entry.launched, entry.graph = launched, graph

    def _replay(self, entry: _Entry, args, stream
                ) -> Tuple[torch.Tensor, ...]:
        """Under the lock: after the previous replay's copies out, copy
        in, replay and copy out on `stream`."""
        stream.wait_event(self._done)
        self._fill(entry.inputs, args)
        entry.graph.replay()
        kernels.add_launches(entry.launched)
        out = tuple(o.clone() for o in entry.outputs)
        self._done.record(stream)
        return out
