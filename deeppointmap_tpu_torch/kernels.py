"""Builds and binds the hand-written CUDA kernels in `csrc/`.

Each source compiles with `nvcc` into its own shared library with a plain
C interface, bound with `ctypes`. A library is built at first use into
`build/kernels/` beside the package (listed in `.gitignore`), under a
name that carries a hash of its source and of the headers it includes, so
an edited kernel is never served from a stale build. `build_all()` starts every `nvcc` at once.
The same build-and-bind helpers (`library_path`, `start_compile`,
`finish_compile`, `bind`) serve the host library in `native/` with g++.

Nothing here runs at import: this module is imported on machines that
have neither `nvcc` nor a GPU, where the ops take their plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(build_dir: Path, stem: str, key: bytes) -> Path:
    """`build_dir/lib<stem>-<hash>.so`, the hash over `key`: everything the
    library depends on (sources, headers, flags)."""
    return build_dir / f"lib{stem}-{hashlib.sha1(key).hexdigest()[:12]}.so"


def start_compile(compiler, flags, source: Path, path: Path):
    """Start `compiler()` on `source` unless `path` exists -> the process
    (or None), so that several builds run at once. Several processes may
    build the same library: each writes its own file and `finish_compile`
    renames it into place atomically."""
    if path.exists():
        return None
    exe = compiler()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([exe, *flags, "-o", str(tmp), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.dpm_build = (Path(exe).name, source, tmp, path)
    return proc


def finish_compile(proc) -> str:
    """Wait for a `start_compile` process and put its library in place ->
    the compiler's output. Raises RuntimeError with that output when the
    compiler refused the source."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    tool, source, tmp, path = proc.dpm_build
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed for {source.name}:\n{out}")
    os.replace(tmp, path)
    return out


def bind(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load the library at `path` and give each symbol in `signatures`
    its argtypes and an int result."""
    lib = ctypes.CDLL(str(path))
    for symbol, argtypes in signatures.items():
        f = getattr(lib, symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def strict_matmuls() -> None:
    """The matmul settings the port's results rely on, process-wide: no
    TF32 (distances at +-60 m need full float32), and a bfloat16 GEMM
    (`tpu.encoder_bf16`) accumulates in float32 to the end, as the TPU's
    MXU does, with no bfloat16 split-K partial sums."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def device_guard(device):
    """Make `device` the calling thread's current CUDA device for the
    duration: the C entry points set kernel attributes and launch on the
    current device, which in a worker thread need not be the tensors'."""
    if device is None:
        return contextlib.nullcontext()
    import torch

    return torch.cuda.device(device)


#: per thread, the launches that a CUDA graph capture holds (`recording`)
_RECORDING = threading.local()


class Kernel:
    """One CUDA source, its C entry point and the count of its launches.

    `launches` counts the launches made through `launch` that run, and
    `shapes` counts them by the shape key the op wrapper passes; nothing
    else changes either. Both are updated under the kernel's lock, since
    the pipelined SLAM mode launches from several threads at once. A
    launch into a CUDA graph capture does not run: `recording` holds it,
    and `add_launches` counts it at each replay of the graph."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 headers: tuple = ()):
        self.name = name
        self.source = CSRC / source
        self.headers = tuple(CSRC / h for h in headers)
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.shapes: Counter = Counter()
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def _lib_path(self) -> Path:
        text = b"".join(f.read_bytes() for f in (self.source, *self.headers))
        return library_path(BUILD_DIR, self.name,
                            text + " ".join(NVCC_FLAGS).encode())

    def start_build(self):
        """Start nvcc for this source unless its library exists."""
        return start_compile(_nvcc, NVCC_FLAGS, self.source,
                             self._lib_path())

    def finish_build(self, proc) -> None:
        if proc is not None:
            self.build_log = finish_compile(proc)

    def fn(self):
        """The bound C entry point, building the library if needed."""
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = bind(self._lib_path(), {self.symbol: self.argtypes})
                self._fn = getattr(lib, self.symbol)
            return self._fn

    def launch(self, *args, device=None, shape: tuple = ()) -> None:
        """Call the entry point (which launches on the given stream) with
        `device` current, raise if the launch was refused, and count it
        under `shape`."""
        fn = self.fn()
        with device_guard(device):
            err = fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch "
                               f"(cudaError {err})")
        captured = getattr(_RECORDING, "launched", None)
        if captured is not None:
            captured[(self, shape)] += 1
            return
        with self._lock:
            self.launches += 1
            self.shapes[shape] += 1


#: K1: batched farthest-point sampling (csrc/fps.cu).
FPS = Kernel("fps", "fps.cu", "dpm_fps", [_P, _P, _I, _I, _I, _P, _P])
#: K2: exact kNN with optional radius moments (csrc/knn.cu).
KNN = Kernel("knn", "knn.cu", "dpm_knn",
             [_P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _I, _P],
             headers=("radius.cuh",))
#: K3: radius-PCA moments (csrc/moments.cu).
MOMENTS = Kernel("moments", "moments.cu", "dpm_moments",
                 [_P, _P, _I, _I, _F, _P, _L, _P, _P],
                 headers=("radius.cuh",))
#: K4: fused sweep, best two per index class + moments (csrc/sweep.cu).
SWEEP = Kernel("sweep", "sweep.cu", "dpm_sweep",
               [_P, _P, _I, _I, _I, _F, _P, _L, _P, _P, _P, _P],
               headers=("radius.cuh",))
#: K5: batched weighted Kabsch solve (csrc/kabsch.cu).
KABSCH = Kernel("kabsch", "kabsch.cu", "dpm_kabsch",
                [_P, _P, _P, _I, _I, _P, _P, _P])
ALL = (FPS, KNN, MOMENTS, SWEEP, KABSCH)


def build_all() -> None:
    """Build every kernel library, all nvcc processes at once."""
    procs = [(k, k.start_build()) for k in ALL]
    for k, p in procs:
        k.finish_build(p)
    for k in ALL:
        k.fn()


@contextlib.contextmanager
def recording():
    """The kernels' launches made on this thread inside the block go to
    the Counter it yields, {(kernel, shape): launches}, and not to the
    kernels' counts: a CUDA graph's capture (a captured launch runs only
    when the graph is replayed), or a warm-up or check that a path's
    counts leave out."""
    prev = getattr(_RECORDING, "launched", None)
    _RECORDING.launched = launched = Counter()
    try:
        yield launched
    finally:
        _RECORDING.launched = prev


def add_launches(launched) -> None:
    """Count the launches of a `recording` once more (a graph replayed)."""
    for (k, shape), n in launched.items():
        with k._lock:
            k.launches += n
            k.shapes[shape] += n


def reset_launches() -> None:
    for k in ALL:
        with k._lock:
            k.launches = 0
            k.shapes.clear()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
