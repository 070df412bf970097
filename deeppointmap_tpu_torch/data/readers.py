"""Point-cloud file readers (host side, NumPy).

The port's own copy of deeppointmap_tpu/data/readers.py (NumPy / scipy only; the
port imports nothing of the JAX package).

Covers the reference's reader heads (reference: dataloader/heads/{auto,bin,
npy,npz,pcd}.py). Each reader returns a `Scan`: xyz plus optional ground
truth pose / normals / labels. A minimal ASCII+binary PCD parser replaces
the reference's Open3D dependency (reference: dataloader/heads/pcd.py:17).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Scan:
    """One LiDAR scan on the host."""

    xyz: np.ndarray                                # (N, 3) float32
    rotation: Optional[np.ndarray] = None          # (3, 3) GT ego rotation
    translation: Optional[np.ndarray] = None       # (3, 1) GT ego translation
    norm: Optional[np.ndarray] = None              # (N, 3)
    label: Optional[np.ndarray] = None             # (N,)
    image: Optional[np.ndarray] = None             # camera image (H, W, C)
    uvd: Optional[np.ndarray] = None               # (N, 3) image-proj coords
    calib: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))

    def __post_init__(self):
        self.xyz = np.ascontiguousarray(self.xyz, dtype=np.float32)
        if self.rotation is None:
            self.rotation = np.eye(3, dtype=np.float32)
        if self.translation is None:
            self.translation = np.zeros((3, 1), dtype=np.float32)
        self.rotation = np.asarray(self.rotation, dtype=np.float32).reshape(3, 3)
        self.translation = np.asarray(self.translation, dtype=np.float32).reshape(3, 1)

    @property
    def n_points(self) -> int:
        return self.xyz.shape[0]

    def keep(self, index_or_mask) -> "Scan":
        """In-place row selection on per-point fields."""
        self.xyz = self.xyz[index_or_mask]
        if self.norm is not None:
            self.norm = self.norm[index_or_mask]
        if self.label is not None:
            self.label = self.label[index_or_mask]
        if self.uvd is not None:
            self.uvd = self.uvd[index_or_mask]
        return self


def read_bin(path: str) -> Scan:
    """KITTI velodyne: (N, 4) float32 x/y/z/intensity; NaN rows dropped
    (reference: dataloader/heads/bin.py:12-25)."""
    xyz = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    xyz = xyz[~np.isnan(xyz).any(axis=1)]
    return Scan(xyz=xyz)


def read_npy(path: str) -> Scan:
    return Scan(xyz=np.load(path))


def read_npz(path: str) -> Scan:
    """npz with 'lidar_pcd' + optional ego pose / normals / segmentation
    (reference: dataloader/heads/npz.py:12-27)."""
    with np.load(path, allow_pickle=True) as z:
        keys = z.files
        assert "lidar_pcd" in keys, "npz must contain 'lidar_pcd'"
        return Scan(
            xyz=z["lidar_pcd"],
            rotation=z["ego_rotation"] if "ego_rotation" in keys else None,
            translation=z["ego_translation"] if "ego_translation" in keys else None,
            norm=z["lidar_norm"] if "lidar_norm" in keys else None,
            label=z["lidar_seg"] if "lidar_seg" in keys else None,
            image=z["image"] if "image" in keys else None,
            uvd=z["lidar_proj"] if "lidar_proj" in keys else None,
        )


def read_pcd(path: str) -> Scan:
    """Minimal PCD v0.7 parser: ascii and binary (non-compressed) forms,
    xyz fields only."""
    with open(path, "rb") as f:
        header: dict[str, list[str]] = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = list(map(int, header["SIZE"]))
        types = header["TYPE"]
        counts = list(map(int, header.get("COUNT", ["1"] * len(fields))))
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = raw.reshape(n, -1)
            col = 0
            cols = {}
            for name, c in zip(fields, counts):
                cols[name] = col
                col += c
            xyz = np.stack([raw[:, cols["x"]], raw[:, cols["y"]], raw[:, cols["z"]]], axis=1)
            return Scan(xyz=xyz.astype(np.float32))
        if mode == "binary":
            fmt_map = {("F", 4): "<f4", ("F", 8): "<f8",
                       ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
                       ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4"}
            dt = []
            for name, t, s, c in zip(fields, types, sizes, counts):
                base = fmt_map[(t, s)]
                dt.append((name, base, (c,)) if c > 1 else (name, base))
            dtype = np.dtype(dt)
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=1)
            return Scan(xyz=xyz.astype(np.float32))
        raise ValueError(f"unsupported PCD data mode: {mode}")


_READERS = {
    ".bin": read_bin,
    ".npy": read_npy,
    ".npz": read_npz,
    ".pcd": read_pcd,
}


def read_auto(path: str) -> Scan:
    """Dispatch on extension (reference: dataloader/heads/auto.py:6-53)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext not in _READERS:
        raise ValueError(f"unsupported point-cloud file type: {ext}")
    return _READERS[ext](path)


def get_reader(name: str):
    """Reader registry (reference: dataloader/body.py:20-26)."""
    table = {"auto": read_auto, "bin": read_bin, "npy": read_npy,
             "npz": read_npz, "pcd": read_pcd}
    return table[name]
