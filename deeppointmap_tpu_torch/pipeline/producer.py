"""The training batch producer: a process of its own that builds the
Trainer's batches, in order, ahead of the step (`num_workers` >= 1).

The Trainer hands it its `BatchBuilder` (pipeline/batching.py: the
dataset, its transforms and the generator they share with the Trainer, in
one pickle, so that they still share it) when it asks for its first
epoch; from then on the producer owns the draws, and the main process
draws nothing more from them. For each epoch the Trainer sends the plan
(`EpochPlan`: stage, curriculum K, steps, items) and takes the batches as
they come; each is byte for byte what the serial path builds from the
same seed.

  * Ahead: the producer keeps up to `DEPTH` batches of the epoch built
    and not yet taken; it starts an epoch when its plan comes.
  * An epoch left early (an exception out of the step) leaks nothing: the
    next plan says how many batches of the last epoch the loop took, and
    the producer puts every generator, and the transform stages'
    attributes, back to where the serial path's would be after them
    before it builds the new epoch (`BatchBuilder.state`). Batches of the
    old epoch still on their way are dropped, never served.
  * Batches cross in shared memory: each is one anonymous file
    (`memfd_create`) whose descriptor is passed over the socket, and the
    main process maps it; no batch array is pickled. The memory goes when the
    last array over it does.
  * In parallel: with `num_workers` >= 2 and a transform chain that draws
    nothing, `num_workers` loader processes (spawned with the producer)
    read and transform the frames; threads would share one interpreter
    lock, and these loads are mostly Python.
    The draws stay in the serial order on the producer's thread.
  * Spans: the producer times each batch under a scope of its own
    (`train.read`, `train.transform`, `train.assemble`, its loaders'
    included) and sends the tally with the batch; the Trainer adds it to
    the step's spans.

The producer is a fresh interpreter (started, never forked, so that no
CUDA state is inherited) that imports no CUDA code path and never
initialises CUDA. This module imports only what the Trainer's end needs:
the producer starts its loaders before it imports the batch modules,
so that all of them import at once, beside the Trainer's own set-up. It
lives as long as its Trainer (`close`) and ends by itself when its parent
goes (the socket closes); its loaders end with it.
"""

from __future__ import annotations

import ctypes
import mmap
import multiprocessing
import os
import signal
import socket
import subprocess
import sys
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from multiprocessing.connection import Connection
from multiprocessing.reduction import recv_handle, send_handle
from typing import TYPE_CHECKING, Dict, Iterator, Tuple

import numpy as np

if TYPE_CHECKING:
    from deeppointmap_tpu_torch.pipeline.batching import (BatchBuilder,
                                                          EpochPlan)

#: batches built and not yet taken, at most
DEPTH = 2
#: seconds the Trainer waits for a message before it takes the producer
#: for hung
WAIT_S = 600.0
#: seconds `close` waits for the producer to exit before it kills it
STOP_S = 10.0

_BOOT = ("import sys; sys.path[:0] = sys.argv[3:]; "
         "from deeppointmap_tpu_torch.pipeline import producer; "
         "producer.serve(int(sys.argv[1]), int(sys.argv[2]))")
_ALIGN = 64


# ------------------------------------------------------------ the batch
def _share(batch) -> Tuple[int, list]:
    """-> (descriptor of an anonymous file holding the batch's arrays,
    their layout [(dtype, shape, offset)])."""
    layout, size = [], 0
    arrays = [np.ascontiguousarray(a) for a in batch]
    for a in arrays:
        layout.append((a.dtype.str, a.shape, size))
        size += -(-a.nbytes // _ALIGN) * _ALIGN
    fd = os.memfd_create("dpm-batch", os.MFD_CLOEXEC)
    try:
        os.ftruncate(fd, size)
        for a, (_, _, off) in zip(arrays, layout):
            view = memoryview(a.reshape(-1)).cast("B")
            while view:
                n = os.pwrite(fd, view, off)
                view, off = view[n:], off + n
    except BaseException:
        os.close(fd)
        raise
    return fd, layout


def _attach(cls, layout, fd: int):
    """The batch over the shared file `fd` (closed here): `cls` of
    arrays that keep its mapping alive."""
    try:
        mm = mmap.mmap(fd, 0)
    finally:
        os.close(fd)
    return cls(*(np.ndarray(shape, np.dtype(dt), buffer=mm, offset=off)
                 for dt, shape, off in layout))


# ---------------------------------------------------- the main process
def _stop(proc: subprocess.Popen, conn: Connection) -> None:
    try:
        conn.send(("stop",))
    except OSError:
        pass
    conn.close()
    try:
        proc.wait(timeout=STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=STOP_S)


class Producer:
    """The Trainer's end: starts the process at once (the interpreter and
    its imports overlap the Trainer's own set-up) and sends it the
    builder with the first plan."""

    def __init__(self, workers: int):
        ours, theirs = socket.socketpair()
        with theirs:
            self._proc = subprocess.Popen(
                [sys.executable, "-c", _BOOT, str(theirs.fileno()),
                 str(int(workers)), *sys.path], pass_fds=(theirs.fileno(),),
                stdin=subprocess.DEVNULL)
        self._conn = Connection(ours.detach())
        self._stop = weakref.finalize(self, _stop, self._proc, self._conn)
        #: torch.cuda.is_initialized() in the producer, once it has its
        #: builder
        self.cuda_initialized = None
        self._taken = None   # batches of the last epoch handed to the loop
        self._owner = None   # the generator serving the epoch

    def close(self) -> None:
        """Stop the producer (bounded wait; killed if it does not exit)."""
        self._stop()

    def _send(self, msg) -> None:
        try:
            self._conn.send(msg)
        except OSError as e:
            raise RuntimeError("the batch producer is gone (exit code "
                               f"{self._proc.poll()})") from e

    def _read(self):
        """The producer's next message (a batch's with its descriptor);
        raises if it failed, died or hung."""
        waited = 0.0
        while not self._conn.poll(1.0):
            waited += 1.0
            if self._proc.poll() is not None:
                raise RuntimeError("the batch producer exited with code "
                                   f"{self._proc.returncode}")
            if waited >= WAIT_S:
                raise RuntimeError(f"no batch from the producer in {WAIT_S} s")
        msg = self._conn.recv()
        if msg[0] == "batch":
            return msg + (recv_handle(self._conn),)
        if msg[0] == "error":
            raise RuntimeError("the batch producer failed:\n" + msg[1])
        return msg

    def batches(self, builder: BatchBuilder, plan: EpochPlan
                ) -> Iterator[Tuple[object, Dict[str, float], bool]]:
        """The epoch's batches in order: (batch, the producer's spans for
        it, whether it was waiting when asked for). `builder` goes to the
        producer with the first plan and is not read again."""
        if self.cuda_initialized is None:
            self._send(builder)
            self.cuda_initialized = self._read()[1]
        self._send(("plan", plan, self._taken))
        self._owner = mine = object()
        msg = self._read()
        while msg[0] == "batch":   # the last epoch's, built ahead
            os.close(msg[-1])
            self._send(("ack",))
            msg = self._read()
        self._taken = 0
        for _ in range(plan.n_steps):
            if self._owner is not mine:
                raise RuntimeError("a newer epoch's batches were asked for")
            was_ready = self._conn.poll(0)
            _, cls, layout, spans, fd = self._read()
            batch = _attach(cls, layout, fd)
            self._taken += 1
            self._send(("ack",))
            yield batch, spans, was_ready


# -------------------------------------------------------- the producer
def _loader_init(parent: int) -> None:
    """A loader process: it ends with the producer, and imports the
    frames' modules before its first frame."""
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(0)
    import deeppointmap_tpu_torch.data.dataset  # noqa: F401


def _loader_pool(workers: int) -> ProcessPoolExecutor:
    """`workers` loader processes for `SlamDatasets.loader`, started now:
    fresh interpreters (spawned: nothing of this process is copied)."""
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_loader_init, initargs=(os.getpid(),))
    for _ in range(workers):   # a process a task until all are started
        pool.submit(int)
    return pool


class _Server:
    def __init__(self, conn: Connection, builder: BatchBuilder, scope):
        self.conn, self.builder, self.scope = conn, builder, scope
        self.plan, self.it, self.j = None, None, 0
        self.states = []       # the build's state after j batches, j = 0..
        self.outstanding = 0   # batches sent and not yet taken or dropped
        self.ppid = os.getppid()

    def _on_plan(self, plan: EpochPlan, taken) -> None:
        if taken is not None:   # where the serial path would stand
            self.builder.set_state(self.states[taken])
        self.plan, self.j = plan, 0
        self.states = [self.builder.state()]
        self.it = self.builder.epoch(plan)
        self.conn.send(("epoch",))

    def _can_build(self) -> bool:
        return self.it is not None and self.j < self.plan.n_steps \
            and self.outstanding < DEPTH

    def _build(self) -> None:
        with self.scope("train.batch", self.j) as tally:
            batch = next(self.it)
        self.states.append(self.builder.state())
        fd, layout = _share(batch)
        try:
            self.conn.send(("batch", type(batch), layout, tally))
            send_handle(self.conn, fd, 0)
        finally:
            os.close(fd)
        self.j += 1
        self.outstanding += 1

    def run(self) -> None:
        while True:
            while self.conn.poll(0 if self._can_build() else 1.0):
                msg = self.conn.recv()
                if msg[0] == "stop":
                    return
                if msg[0] == "ack":
                    self.outstanding -= 1
                else:
                    self._on_plan(msg[1], msg[2])
            if os.getppid() != self.ppid:
                return
            if self._can_build():
                self._build()


def serve(fd: int, workers: int) -> None:
    """The producer process's main: builds batches for the Trainer at the
    other end of socket `fd` until it says stop or goes; with `workers` >=
    2 its frames load in that many loader processes, used if the chain
    draws nothing."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)   # the parent decides
    loader = _loader_pool(workers) if workers > 1 else None
    conn = Connection(fd)
    try:
        import torch

        from deeppointmap_tpu_torch.utils import timer
        builder = conn.recv()
        conn.send(("ready", torch.cuda.is_initialized()))
        if loader is not None and not builder.dataset.transforms_draw():
            builder.dataset.loader = loader
        _Server(conn, builder, timer.scope).run()
    except (EOFError, BrokenPipeError, ConnectionResetError):
        pass   # the Trainer has gone
    except Exception:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
    finally:
        if loader is not None:
            loader.shutdown(cancel_futures=True)
