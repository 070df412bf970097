"""Host-side voxel-grid downsampling (port of deeppointmap_tpu/data/
voxel.py).

Semantics mirror the reference transform (reference: dataloader/
transforms.py:322-356): one point retained per occupied voxel, either the
first point in input order ('first') or the point closest to the voxel
center ('center'); optional cap to the `num` most-populated voxels.

This runs on the host because it is the *first* step of the pipeline (raw
scans are ~122k points and variable-size); its output feeds the fixed-shape
device pipeline. 'first' retention without a cap takes the native hash
pass (deeppointmap_tpu_torch/native), as in the JAX package; everything
else is vectorized NumPy -- a single sort + unique over int64 voxel keys
(`voxel_downsample_indices_numpy`, also the plain version the native route
is tested against).
"""

from __future__ import annotations

import numpy as np

from deeppointmap_tpu_torch import native


def voxel_ids(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Linearized voxel index per point (int64, collision-free)."""
    mn = xyz.min(axis=0)
    v = ((xyz - mn) / voxel_size).astype(np.int64)
    dims = v.max(axis=0) + 1
    return v[:, 0] + v[:, 1] * dims[0] + v[:, 2] * dims[0] * dims[1]


def voxel_downsample_indices(
    xyz: np.ndarray,
    voxel_size: float,
    retention: str = "center",
    num: int | None = None,
) -> np.ndarray:
    """Indices (into xyz) of retained points, ordered by ascending voxel
    id (matching the reference's np.unique ordering,
    dataloader/transforms.py:349)."""
    assert retention in ("first", "center")
    if xyz.shape[0] and num is None and retention == "first":
        # the native pass keeps the same survivors in first-seen order;
        # 'center' stays NumPy: float rounding in the center distance
        # flips near-tie winners
        keep = native.LIB.voxel_downsample_first(xyz, voxel_size)
        vid = voxel_ids(xyz, voxel_size)
        return keep[np.argsort(vid[keep], kind="stable")]
    return voxel_downsample_indices_numpy(xyz, voxel_size, retention, num)


def voxel_downsample_indices_numpy(
    xyz: np.ndarray,
    voxel_size: float,
    retention: str = "center",
    num: int | None = None,
) -> np.ndarray:
    """voxel_downsample_indices in NumPy alone."""
    n = xyz.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int64)

    vid = voxel_ids(xyz, voxel_size)

    if retention == "center":
        mn = xyz.min(axis=0)
        rel = xyz - mn
        vxyz = (rel / voxel_size).astype(np.int64)
        d2 = np.sum((rel - vxyz * voxel_size - voxel_size / 2.0) ** 2, axis=1)
        order = np.argsort(d2, kind="stable")
    else:
        order = np.arange(n)

    vid_sorted = vid[order]
    uniq, first_pos, counts = np.unique(vid_sorted, return_index=True, return_counts=True)
    keep = order[first_pos]

    if num is not None and keep.shape[0] > num:
        top = np.argpartition(counts, -num)[-num:]
        keep = keep[top]
    return keep


def voxel_downsample(xyz: np.ndarray, voxel_size: float,
                     retention: str = "center", num: int | None = None) -> np.ndarray:
    return xyz[voxel_downsample_indices(xyz, voxel_size, retention, num)]
