"""Trajectory evaluation CLI (the port's counterpart of scripts/evaluate.py,
an in-repo replacement for the `evo` toolkit the reference points to):
ATE RMSE with and without a rigid alignment, RPE, and the KITTI odometry
benchmark's errors.

    python -m deeppointmap_tpu_torch.pipeline.evaluate PRED.txt GT.txt \
        [--delta 1] [--no-align] [--json]

Both files are KITTI-format trajectories (rows of flattened 3x4 poses), such
as the `trajectory.allframes.txt` the SLAM system writes. When their lengths
differ the common prefix is compared (the system may drop scans).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from deeppointmap_tpu_torch.utils.evaluation import (ate_rmse,
                                                     kitti_odometry_errors,
                                                     load_kitti_trajectory,
                                                     rpe)


def evaluate(pred_path: str, gt_path: str, delta: int = 1,
             align: bool = True) -> dict:
    pred = load_kitti_trajectory(pred_path)
    gt = load_kitti_trajectory(gt_path)
    n = min(len(pred), len(gt))
    pred, gt = pred[:n], gt[:n]
    path_len = float(np.sum(np.linalg.norm(
        np.diff(gt[:, :3, 3], axis=0), axis=1)))
    rpe_t, rpe_r = rpe(pred, gt, delta=delta)
    kitti_t, kitti_r = kitti_odometry_errors(pred, gt)
    return {
        "frames": n,
        "path_length_m": round(path_len, 2),
        "ate_rmse_m": round(ate_rmse(pred, gt, align=align), 4),
        "ate_rmse_unaligned_m": round(ate_rmse(pred, gt, align=False), 4),
        f"rpe_trans_m_delta{delta}": round(rpe_t, 4),
        f"rpe_rot_deg_delta{delta}": round(rpe_r, 4),
        # a path shorter than the benchmark's shortest segment has none
        "kitti_trans_err_pct": (None if np.isnan(kitti_t)
                                else round(kitti_t, 3)),
        "kitti_rot_err_deg_per_100m": (None if np.isnan(kitti_r)
                                       else round(kitti_r, 4)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pred", help="predicted KITTI trajectory file")
    ap.add_argument("gt", help="ground-truth KITTI trajectory file")
    ap.add_argument("--delta", type=int, default=1, help="RPE step")
    ap.add_argument("--no-align", action="store_true",
                    help="skip the rigid alignment before ATE")
    ap.add_argument("--json", action="store_true", help="one-line JSON")
    ns = ap.parse_args(argv)
    res = evaluate(ns.pred, ns.gt, delta=ns.delta, align=not ns.no_align)
    if ns.json:
        print(json.dumps(res))
    else:
        width = max(len(k) for k in res)
        for k, v in res.items():
            print(f"{k:<{width}}  {v}")
    return res


if __name__ == "__main__":
    main()
