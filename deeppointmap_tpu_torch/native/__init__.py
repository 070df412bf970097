"""The host's native library, C++ bound with ctypes (port of
deeppointmap_tpu/native/): voxel-grid downsampling with 'first' retention
in one hash pass (data/voxel.py takes it where the JAX package does) and
the KITTI .bin reader, which, as in the JAX package, nothing calls.

`voxel_native.cpp` is built at first use with g++ and the JAX package's
Makefile flags, through the kernels' build helpers (`kernels.py`), into `build/native/` beside the package (listed in
`.gitignore`), under a name that carries a hash of the source, the flags
and the host CPU's feature flags (`-march=native` builds for that CPU, and
a checkout may be copied to another host). It is built once per process,
under a lock: the pipelined SlamSystem's threads and the multi-agent feed
threads downsample at the same time. A failed
build raises with the compiler's output; where the JAX package falls back
to NumPy with a warning, the port does not. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import platform
import shutil
import threading
from pathlib import Path

import numpy as np

from deeppointmap_tpu_torch import kernels

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "voxel_native.cpp"
BUILD_DIR = _PKG.parent.parent / "build" / "native"
#: deeppointmap_tpu/native/Makefile's CXXFLAGS and -shared
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]

_P = ctypes.c_void_p


def _host_cpu() -> bytes:
    """What `-march=native` compiles for: the CPU's feature flags."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native library cannot be "
                           "built")
    return found


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` into `build_dir` unless its library is there ->
    the library's path. Raises RuntimeError with g++'s output when the
    compiler is missing or refuses the source."""
    path = kernels.library_path(
        build_dir, source.stem,
        source.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_cpu())
    kernels.finish_compile(kernels.start_compile(_gxx, CXX_FLAGS, source,
                                                 path))
    return path


class NativeLibrary:
    """The bound library and the count of `voxel_downsample` calls
    (`voxel_calls`, updated under the lock, as the kernels' launches)."""

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR):
        self.source, self.build_dir = source, build_dir
        self.voxel_calls = 0
        self._lib = None
        self._lock = threading.Lock()

    def lib(self) -> ctypes.CDLL:
        """The bound library, built on the first call."""
        with self._lock:
            if self._lib is None:
                self._lib = kernels.bind(
                    build(self.source, self.build_dir),
                    {"voxel_downsample": [_P, ctypes.c_int64, ctypes.c_float,
                                          _P],
                     "read_kitti_xyz": [_P, ctypes.c_int64, _P]})
            return self._lib

    def voxel_downsample_first(self, xyz: np.ndarray,
                               voxel_size: float) -> np.ndarray:
        """Indices (int64) of the first point of each occupied voxel, in
        the order the voxels are first seen. xyz (N, 3) is taken as
        float32."""
        xyz = np.ascontiguousarray(xyz, dtype=np.float32)
        if xyz.ndim != 2 or xyz.shape[1] != 3:
            raise ValueError(f"xyz must be (N, 3), got {xyz.shape}")
        if not voxel_size > 0:
            raise ValueError(f"voxel_size must be > 0, got {voxel_size}")
        n = xyz.shape[0]
        if n >= 2 ** 31:
            raise ValueError(f"{n} points exceed the int32 indices")
        lib = self.lib()
        out = np.empty(n, dtype=np.int32)
        k = lib.voxel_downsample(xyz.ctypes.data, n, voxel_size,
                                 out.ctypes.data)
        with self._lock:
            self.voxel_calls += 1
        return out[:k].astype(np.int64)

    def read_kitti_xyz(self, raw: np.ndarray) -> np.ndarray:
        """(N, 4) float32 KITTI rows -> (M, 3) xyz with NaN rows dropped."""
        raw = np.ascontiguousarray(raw, dtype=np.float32)
        if raw.ndim != 2 or raw.shape[1] != 4:
            raise ValueError(f"raw must be (N, 4), got {raw.shape}")
        out = np.empty((raw.shape[0], 3), dtype=np.float32)
        k = self.lib().read_kitti_xyz(raw.ctypes.data, raw.shape[0],
                                      out.ctypes.data)
        return out[:k]


#: the library of this package's own source
LIB = NativeLibrary()
