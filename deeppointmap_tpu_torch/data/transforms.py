"""Point-cloud preprocessing & augmentation (host-side, NumPy; the port's
own copy of deeppointmap_tpu/data/transforms.py, which the port does not
import).

Parity with the reference transform zoo (reference: dataloader/
transforms.py:17-661): the same registry names, yaml-dict construction and
train/infer call conventions over a NumPy `Scan` container (NumPy + scipy
cKDTree). The inference chain's device twin is data/preprocess.py; this
host chain serves `tpu.device_preprocess: false` and any chain with other
stages than the standard one.

Conventions:
  * Scan.xyz is (N, 3) float32; pose R (3,3) / T (3,1) maps scan -> world.
  * ToTensor pads to `padding_to` and returns a True=valid mask (the
    reference returns the inverted padding mask, transforms.py:84-87).
  * Random transforms draw from a per-pipeline np.random.Generator seeded
    by the caller (the reference uses global `random`/torch RNG).
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np
from scipy.spatial import cKDTree

from deeppointmap_tpu_torch.data.readers import Scan
from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, scan: Scan):
        for t in self.transforms:
            scan = t(scan)
        return scan


class RandomChoice:
    """Pick one sub-transform by weight (reference: transforms.py:153-171)."""

    def __init__(self, transforms, p=None, rng=None):
        self.transforms = transforms
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, scan: Scan):
        w = None
        if self.p is not None:
            w = np.asarray(self.p, dtype=np.float64)
            w = w / w.sum()
        t = self.rng.choice(len(self.transforms), p=w)
        return self.transforms[int(t)](scan)


class VoxelSample:
    """One point per occupied voxel (reference: transforms.py:322-356)."""

    def __init__(self, voxel_size: float, retention: str = "center",
                 num: Optional[int] = None):
        assert retention in ("first", "center")
        self.voxel_size = voxel_size
        self.retention = retention
        self.num = num

    def __call__(self, scan: Scan):
        keep = voxel_downsample_indices(scan.xyz, self.voxel_size,
                                        self.retention, self.num)
        scan.keep(keep)
        return scan


class DistanceSample:
    """Keep min_dis <= |p| <= max_dis (reference: transforms.py:387-397)."""

    def __init__(self, min_dis: float, max_dis: float):
        self.min_dis, self.max_dis = min_dis, max_dis

    def __call__(self, scan: Scan):
        d = np.linalg.norm(scan.xyz, axis=1)
        scan.keep((d >= self.min_dis) & (d <= self.max_dis))
        return scan


class OutlierFilter:
    """Statistical kNN outlier removal (reference: transforms.py:230-253):
    drop points whose mean distance to the nb_neighbors nearest points
    exceeds mean + std_ratio * std."""

    def __init__(self, nb_neighbors: int, std_ratio: float):
        self.nb_neighbors = nb_neighbors
        self.std_ratio = std_ratio

    def __call__(self, scan: Scan):
        n = scan.n_points
        if n <= self.nb_neighbors:
            return scan
        tree = cKDTree(scan.xyz)
        d, _ = tree.query(scan.xyz, k=self.nb_neighbors + 1, workers=-1)
        mean_d = d[:, 1:].mean(axis=1)
        mu, sd = mean_d.mean(), mean_d.std()
        scan.keep(mean_d <= mu + self.std_ratio * sd)
        return scan


def estimate_normals(xyz: np.ndarray, radius: float) -> np.ndarray:
    """Unit normals via PCA over ALL points within `radius` -- the
    reference's exact Open3D semantics (KDTreeSearchParamRadius, no
    neighbor cap; reference: transforms.py:271), matching the device
    chain's `ops.normals.radius_normals`. Vectorized as a query_pairs
    moment accumulation (no per-point Python loop): each pair
    contributes its endpoint to the other endpoint's first/second
    moments, then the per-point covariance is recovered in float64."""
    n = xyz.shape[0]
    pts = xyz.astype(np.float64)
    pairs = cKDTree(pts).query_pairs(radius, output_type="ndarray")
    # both directions of each pair, bincount-accumulated per column
    # (np.add.at is an unbuffered scatter, ~10-100x slower)
    idx = np.concatenate([pairs[:, 0], pairs[:, 1]])
    src = np.concatenate([pairs[:, 1], pairs[:, 0]])
    p6 = np.einsum("ni,nj->nij", pts, pts).reshape(n, 9)

    cnt = 1.0 + np.bincount(idx, minlength=n).astype(np.float64)
    s = pts + np.stack([np.bincount(idx, weights=pts[src, c], minlength=n)
                        for c in range(3)], axis=1)
    S9 = p6 + np.stack([np.bincount(idx, weights=p6[src, c], minlength=n)
                        for c in range(9)], axis=1)

    mean = s / cnt[:, None]
    cov = S9.reshape(n, 3, 3) / cnt[:, None, None] \
        - np.einsum("ni,nj->nij", mean, mean)
    _, vecs = np.linalg.eigh(cov)            # ascending eigenvalues
    return vecs[:, :, 0].astype(np.float32)  # smallest -> normal


class LowPassFilter:
    """Normal-coherence low-pass filter (reference: transforms.py:256-297):
    keep points whose top-`flux` neighbor-normal |cos| sum is above
    mean - filter_std * std."""

    def __init__(self, normals_radius: float, normals_num: int,
                 filter_std: float, flux: int = 2, max_remain: int = -1):
        self.normals_radius = normals_radius
        self.normals_num = normals_num
        self.filter_std = filter_std
        self.flux = flux
        self.max_remain = max_remain

    def __call__(self, scan: Scan):
        n = scan.n_points
        if n <= self.normals_num + 1:
            return scan
        normals = estimate_normals(scan.xyz, self.normals_radius)
        tree = cKDTree(scan.xyz)
        _, idx = tree.query(scan.xyz, k=self.normals_num + 1, workers=-1)
        nbr_normals = normals[idx[:, 1:]]                     # (N, K, 3)
        sim = np.abs(np.einsum("nkc,nc->nk", nbr_normals, normals))
        top = np.sort(sim, axis=1)[:, -self.flux:]
        s = top.sum(axis=1)
        mask = s > (s.mean() - self.filter_std * s.std())
        if 0 < self.max_remain < mask.sum():
            keep = np.argsort(s)[-self.max_remain:]
            scan.keep(keep)
        else:
            scan.keep(mask)
        return scan


class GroundFilter:
    """Grid height-difference ground removal (reference:
    transforms.py:174-227): points outside the grid are dropped; grids with
    height span > ground_height are kept whole; flat (ground) grids keep one
    representative point when preserve_sparse_ground."""

    def __init__(self, img_len: int, img_width: int, grid_width: float,
                 ground_height: float, preserve_sparse_ground: bool = True):
        self.img_len = img_len
        self.img_width = img_width
        self.grid_width = grid_width
        self.ground_height = ground_height
        self.preserve_sparse_ground = preserve_sparse_ground

    def __call__(self, scan: Scan):
        if self.ground_height <= 0:
            return scan
        xyz = scan.xyz
        row = (xyz[:, 0] / self.grid_width + self.img_len / 2).astype(np.int32)
        col = (xyz[:, 1] / self.grid_width + self.img_width / 2).astype(np.int32)
        inside = (row >= 0) & (row < self.img_len) & (col >= 0) & (col < self.img_width)
        ids = np.nonzero(inside)[0]
        gid = row[ids] * self.img_width + col[ids]
        order = np.argsort(gid, kind="stable")
        ids, gid = ids[order], gid[order]
        z = xyz[ids, 2]
        if len(gid) == 0:
            scan.keep(np.zeros((0,), dtype=np.int64))
            return scan
        # vectorized per-grid stats (a 122k-pt scan has thousands of
        # occupied grids; the reference loops in torch, we segment-reduce)
        _, starts = np.unique(gid, return_index=True)
        counts = np.diff(np.append(starts, len(gid)))
        span = (np.maximum.reduceat(z, starts)
                - np.minimum.reduceat(z, starts))
        dense = counts >= 3
        tall = dense & (span > self.ground_height)       # keep whole grid
        flat = dense & ~tall if self.preserve_sparse_ground \
            else np.zeros_like(dense)                    # keep one point
        pos_mask = np.repeat(tall, counts)
        pos_mask[starts[flat]] = True
        scan.keep(ids[pos_mask])
        return scan


class VerticalCorrect:
    """Per-point tilt correction toward +z (reference: transforms.py:300-319)."""

    def __init__(self, angle: float):
        self.angle = angle

    def __call__(self, scan: Scan):
        if self.angle == 0:
            return scan
        from scipy.spatial.transform import Rotation
        xyz = scan.xyz
        axis = np.cross(xyz, np.array([0.0, 0.0, 1.0]))
        nrm = np.linalg.norm(axis, axis=1, keepdims=True)
        axis = axis / np.maximum(nrm, 1e-12)
        rot = Rotation.from_rotvec(axis * self.angle, degrees=True).as_matrix()
        scan.xyz = np.einsum("nij,nj->ni", rot, xyz).astype(np.float32)
        return scan


class FarthestPointSample:
    """Host FPS downsample (reference: transforms.py:359-372)."""

    def __init__(self, num: int):
        self.num = num

    def __call__(self, scan: Scan):
        n = scan.n_points
        if n <= self.num:
            return scan
        xyz = scan.xyz
        sel = np.zeros(self.num, dtype=np.int64)
        mind = np.full(n, np.inf, dtype=np.float32)
        cur = 0
        for i in range(1, self.num):
            d = np.sum((xyz - xyz[cur]) ** 2, axis=1)
            mind = np.minimum(mind, d)
            cur = int(np.argmax(mind))
            sel[i] = cur
        scan.keep(sel)
        return scan


class RandomSample:
    def __init__(self, num: int, rng=None):
        self.num = num
        self.rng = rng or np.random.default_rng()

    def __call__(self, scan: Scan):
        if scan.n_points > self.num:
            scan.keep(self.rng.permutation(scan.n_points)[:self.num])
        return scan


class CoordinatesNormalization:
    def __init__(self, ratio: float):
        self.ratio = ratio

    def __call__(self, scan: Scan):
        scan.xyz = scan.xyz / self.ratio
        return scan


class RandomShuffle:
    def __init__(self, p: float = 1.0, rng=None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, scan: Scan):
        if self.rng.random() > self.p:
            return scan
        scan.keep(self.rng.permutation(scan.n_points))
        return scan


class RandomDrop:
    def __init__(self, max_ratio: float, p: float = 1.0, rng=None):
        self.max_ratio = max_ratio
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, scan: Scan):
        if self.rng.random() > self.p:
            return scan
        ratio = self.rng.uniform(0, self.max_ratio)
        scan.keep(self.rng.random(scan.n_points) >= ratio)
        return scan


class RandomOcclusion:
    """Angular sector shields (reference: transforms.py:438-474)."""

    def __init__(self, angle_range: list, dis_range: list, max_num: int,
                 p: float = 0.1, rng=None):
        self.angle_range = angle_range
        self.dis_range = dis_range
        self.max_num = max_num
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, scan: Scan):
        if self.rng.random() > self.p:
            return scan
        xyz = scan.xyz
        azim = np.arctan2(xyz[:, 0], xyz[:, 1]) * 180.0 / math.pi
        dist = np.linalg.norm(xyz, axis=1)
        mask = np.ones(scan.n_points, dtype=bool)
        num = self.rng.integers(1, self.max_num + 1)
        for i in range(num):
            a, d, direc = self.rng.random(3)
            angle = (a * (self.angle_range[1] - self.angle_range[0])
                     + self.angle_range[0]) / (i + 1)
            dis_th = d * (self.dis_range[1] - self.dis_range[0]) + self.dis_range[0]
            direc = direc * 360.0 - 180.0
            start, end = direc, direc + angle
            if end <= 180:
                shield = (azim >= start) & (azim <= end)
            else:
                shield = (azim >= start) | (azim <= end - 360.0)
            mask &= ~(shield & (dist >= dis_th))
        scan.keep(mask)
        return scan


class RandomRT:
    """Paired random rigid augmentation keeping the relative pose
    (reference: transforms.py:477-547). With pair=True, consecutive calls
    share the base rotation so frame pairs stay consistently augmented."""

    def __init__(self, r_mean: float = 0.0, r_std: float = 3.14,
                 t_mean: float = 0.0, t_std: float = 1.0,
                 p: float = 1.0, pair: bool = True, rng=None):
        self.r_mean, self.r_std = r_mean, r_std
        self.t_mean, self.t_std = t_mean, t_std
        self.p = p
        self.pair = pair
        self.flag = True
        self.random_R: Optional[np.ndarray] = None
        self.rng = rng or np.random.default_rng()

    def _euler(self, spread: float) -> np.ndarray:
        x, y, z = (self.rng.random(3) - 0.5) * 2.0 * spread
        x, y = x / 10.0, y / 10.0
        cx, sx, cy, sy, cz, sz = (math.cos(x), math.sin(x), math.cos(y),
                                  math.sin(y), math.cos(z), math.sin(z))
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return (rx @ ry @ rz).astype(np.float32)

    def __call__(self, scan: Scan):
        if self.rng.random() > self.p:
            return scan
        if self.pair:
            if self.flag:
                R_aug = self._euler(math.pi)
                self.random_R = R_aug
            else:
                R_aug = self._euler(self.r_std) @ self.random_R
            self.flag = not self.flag
        else:
            R_aug = self._euler(self.r_std)

        if self.t_std > 0:
            T_aug = self.rng.normal(self.t_mean, self.t_std,
                                    size=(3, 1)).astype(np.float32)
            T_aug[2] /= 2.0
        else:
            T_aug = np.zeros((3, 1), dtype=np.float32)

        scan.xyz = (R_aug @ scan.xyz.T + T_aug).T.astype(np.float32)
        if scan.norm is not None:
            scan.norm = (R_aug @ scan.norm.T).T.astype(np.float32)
        R_new = scan.rotation @ R_aug.T
        T_new = scan.translation - R_new @ T_aug
        calib = np.eye(4, dtype=np.float32)
        calib[:3, :3] = R_aug
        calib[:3, 3:] = T_aug
        scan.calib = calib @ scan.calib
        scan.rotation, scan.translation = R_new.astype(np.float32), T_new.astype(np.float32)
        return scan


class RandomPosJitter:
    def __init__(self, mean: float = 0.0, std: float = 0.05, p: float = 1.0,
                 rng=None):
        self.mean, self.std, self.p = mean, std, p
        self.rng = rng or np.random.default_rng()

    def __call__(self, scan: Scan):
        if self.rng.random() > self.p:
            return scan
        jit = self.rng.normal(self.mean, self.std, size=(scan.n_points, 3))
        jit = np.clip(jit, -3 * self.std, 3 * self.std).astype(np.float32)
        scan.xyz = scan.xyz + jit
        return scan


class _NoOp:
    """ToGPU / ToCPU are device-placement hints in the reference
    (transforms.py:567-586); the engine places its inputs itself."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, scan: Scan):
        return scan


def to_padded(scan: Scan, padding_to: int = -1):
    """-> (points (P, 3) f32, R (3,3), T (3,1), valid (P,) bool).
    P = padding_to, or N un-padded when padding_to <= 0 (reference
    semantics: transforms.py:69-98, inverted mask convention)."""
    n = scan.n_points
    if padding_to > 0:
        if n > padding_to:
            raise RuntimeError(
                f"point count ({n}) exceeds padding_to ({padding_to})")
        pts = np.zeros((padding_to, 3), dtype=np.float32)
        pts[:n] = scan.xyz
        valid = np.zeros((padding_to,), dtype=bool)
        valid[:n] = True
    else:
        pts = scan.xyz
        valid = np.ones((n,), dtype=bool)
    return pts, scan.rotation, scan.translation, valid


class ToTensor:
    def __init__(self, padding_to: int = -1, **kwargs):
        self.padding_to = padding_to

    def __call__(self, scan: Scan):
        return to_padded(scan, padding_to=self.padding_to)


TRANSFORMS = {
    "GroundFilter": GroundFilter,
    "OutlierFilter": OutlierFilter,
    "LowPassFilter": LowPassFilter,
    "VerticalCorrect": VerticalCorrect,
    "VoxelSample": VoxelSample,
    "FarthestPointSample": FarthestPointSample,
    "RandomSample": RandomSample,
    "DistanceSample": DistanceSample,
    "CoordinatesNormalization": CoordinatesNormalization,
    "RandomShuffle": RandomShuffle,
    "RandomDrop": RandomDrop,
    "RandomShield": RandomOcclusion,
    "RandomRT": RandomRT,
    "RandomPosJitter": RandomPosJitter,
    "ToGPU": _NoOp,
    "ToCPU": _NoOp,
    "ToTensor": ToTensor,
}

_RANDOM = {"RandomSample", "RandomShuffle", "RandomDrop", "RandomShield",
           "RandomRT", "RandomPosJitter"}


def get_transforms(args_dict: dict, rng=None, return_list: bool = False
                   ) -> Union[Compose, List]:
    """Build a pipeline from the yaml `transforms:` dict
    (reference: transforms.py:625-637)."""
    rng = rng or np.random.default_rng()
    out = []
    for key, value in args_dict.items():
        if key == "RandomChoice":
            subs = get_transforms(value["transforms"], rng, return_list=True)
            out.append(RandomChoice(subs, p=value.get("p"), rng=rng))
        elif key in _RANDOM:
            out.append(TRANSFORMS[key](**value, rng=rng))
        else:
            out.append(TRANSFORMS[key](**value))
    return out if return_list else Compose(out)


class PointCloudTransforms:
    """Train/infer pipeline wrapper (reference: transforms.py:640-661);
    infer mode also returns the original (pre-transform) scan."""

    def __init__(self, args, mode: str = "train", rng=None):
        assert mode in ("train", "infer")
        self.transforms = get_transforms(dict(args.transforms), rng=rng)
        self.mode = mode

    def __call__(self, scan: Scan):
        if self.mode == "train":
            return self.transforms(scan)
        original = scan.xyz.copy()
        result = self.transforms(scan)
        return (*result, original)
