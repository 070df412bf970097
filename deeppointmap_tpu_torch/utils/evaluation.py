"""Trajectory evaluation: ATE / RPE in KITTI format.

The port's own copy of deeppointmap_tpu/utils/evaluation.py (NumPy only;
the port imports nothing of the JAX package).

The reference defers accuracy evaluation to the external `evo` toolkit
(reference: README.md:63-71,130-139); this module implements the same
standard metrics natively so that runs are scored on their own:
  * ATE RMSE after Umeyama/SE3 alignment (evo's ape -a equivalent)
  * RPE translation/rotation per step
  * the KITTI benchmark's errors over sub-sequences of standard lengths
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deeppointmap_tpu_torch.utils import se3 as se3m


def load_kitti_trajectory(path: str) -> np.ndarray:
    """KITTI 3x4-rows file -> (N, 4, 4) float64."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows
    return out


def align_se3(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares SE3 aligning src positions (N, 3) onto dst (N, 3)
    (Umeyama without scale)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    S = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(S)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return se3m.se3(R, t)


def ate_rmse(pred: np.ndarray, gt: np.ndarray, align: bool = True
             ) -> float:
    """Absolute trajectory error RMSE over positions. pred/gt (N, 4, 4)."""
    p = pred[:, :3, 3]
    g = gt[:, :3, 3]
    if align:
        T = align_se3(p, g)
        p = p @ T[:3, :3].T + T[:3, 3]
    return float(np.sqrt(np.mean(np.sum((p - g) ** 2, axis=1))))


def rpe(pred: np.ndarray, gt: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Relative pose error over `delta`-step pairs ->
    (trans RMSE meters, rot RMSE degrees)."""
    terrs, rerrs = [], []
    for i in range(len(pred) - delta):
        dp = se3m.inv(pred[i]) @ pred[i + delta]
        dg = se3m.inv(gt[i]) @ gt[i + delta]
        e = se3m.inv(dg) @ dp
        terrs.append(np.sum(e[:3, 3] ** 2))
        rerrs.append(se3m.rotation_angle(e[:3, :3]) ** 2)
    return (float(np.sqrt(np.mean(terrs))),
            float(np.degrees(np.sqrt(np.mean(rerrs)))))


def kitti_odometry_errors(pred: np.ndarray, gt: np.ndarray,
                          lengths=(100, 200, 300, 400, 500, 600, 700, 800)
                          ) -> Tuple[float, float]:
    """KITTI benchmark style: average translational error (%) and
    rotational error (deg/100m) over sub-sequences of standard lengths."""
    dists = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1))])

    def frame_at(start: int, length: float) -> Optional[int]:
        target = dists[start] + length
        j = np.searchsorted(dists, target)
        return int(j) if j < len(dists) else None

    terr, rerr, count = 0.0, 0.0, 0
    for start in range(0, len(pred), 10):
        for L in lengths:
            end = frame_at(start, L)
            if end is None:
                continue
            dp = se3m.inv(pred[start]) @ pred[end]
            dg = se3m.inv(gt[start]) @ gt[end]
            e = se3m.inv(dg) @ dp
            terr += np.linalg.norm(e[:3, 3]) / L
            rerr += np.degrees(se3m.rotation_angle(e[:3, :3])) / L * 100.0
            count += 1
    if count == 0:
        return float("nan"), float("nan")
    return 100.0 * terr / count, rerr / count
