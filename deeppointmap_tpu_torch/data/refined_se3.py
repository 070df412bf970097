"""A scene's refined_SE3.pkl: ICP-refined pairwise ground truth (port of
scripts/make_refined_se3.py; NumPy / scipy only).

The reference's stage-1 training re-centers map groups with ICP-refined
relative poses loaded from a per-scene `refined_SE3.pkl`
(reference: pipeline/modules/model_pipeline.py:199-272). That artifact
ships with the (unavailable) training datasets; this tool regenerates it
from GT-posed frames (SURVEY.md section 7.3-6): point-to-point ICP between
every frame pair within --max_distance, initialized from the GT relative
pose.

Schema (must match get_SE3_from_dict, model_pipeline.py:285-298):
    { (i, j) : SE3 (4, 4) float64 }  with i < j, where SE3 maps frame-j
    coordinates into frame i (later -> earlier); the (s -> d) lookup with
    s < d inverts it, and missing pairs compose through a bridge frame.

Usage:
    python -m deeppointmap_tpu_torch.data.refined_se3 --scene <scene_dir> \
        [--max_distance 20] [--voxel 0.5] [--iters 20] [--max_corr 1.0] \
        [--output <scene_dir>/refined_SE3.pkl]

The scene dir holds agent subdirectories of npz/bin/npy/pcd frames (the
SlamDatasets layout); GT poses come from the frame files.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from deeppointmap_tpu_torch.data.readers import Scan, read_auto
from deeppointmap_tpu_torch.data.voxel import voxel_downsample


def icp_point_to_point(src: np.ndarray, dst: np.ndarray,
                       init_SE3: np.ndarray, iters: int = 20,
                       max_corr: float = 1.0,
                       tol: float = 1e-6) -> Tuple[np.ndarray, float]:
    """Refine SE3 (src frame -> dst frame) by point-to-point ICP.

    Returns (SE3, inlier rmse). Host-side NumPy/scipy: this is an offline
    dataset-preparation tool, not an inference hot path."""
    from scipy.spatial import cKDTree

    T = np.asarray(init_SE3, np.float64).copy()
    tree = cKDTree(dst)
    prev_rmse = np.inf
    rmse = np.inf
    for _ in range(iters):
        moved = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(moved, distance_upper_bound=max_corr)
        m = np.isfinite(d)
        if m.sum() < 10:
            break
        p = src[m]
        q = dst[idx[m]]
        rmse = float(np.sqrt(np.mean(d[m] ** 2)))
        # Kabsch on the correspondence set
        pm, qm = p.mean(0), q.mean(0)
        H = (p - pm).T @ (q - qm)
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        t = qm - R @ pm
        T_new = np.eye(4)
        T_new[:3, :3] = R
        T_new[:3, 3] = t
        if np.abs(prev_rmse - rmse) < tol:
            T = T_new
            break
        T = T_new
        prev_rmse = rmse
    return T, rmse


def gt_relative_SE3(scan_src: Scan, scan_dst: Scan) -> np.ndarray:
    """GT SE3 mapping src frame coords into dst frame coords."""
    Ts = np.eye(4)
    Ts[:3, :3] = scan_src.rotation
    Ts[:3, 3:] = scan_src.translation
    Td = np.eye(4)
    Td[:3, :3] = scan_dst.rotation
    Td[:3, 3:] = scan_dst.translation
    return np.linalg.inv(Td) @ Ts


def refine_scene(scans: List[Scan], max_distance: float = 20.0,
                 voxel: float = 0.5, iters: int = 20,
                 max_corr: float = 1.0) -> Dict[Tuple[int, int], np.ndarray]:
    """All-pairs-within-radius ICP refinement. Keys (i, j) with i < j;
    value maps frame j coords -> frame i coords."""
    down = [voxel_downsample(np.asarray(s.xyz, np.float64), voxel)
            for s in scans]
    centers = np.stack([s.translation.reshape(3) for s in scans])
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for i in range(len(scans)):
        for j in range(i + 1, len(scans)):
            if np.linalg.norm(centers[i] - centers[j]) > max_distance:
                continue
            init = gt_relative_SE3(scans[j], scans[i])   # j -> i
            T, rmse = icp_point_to_point(down[j], down[i], init,
                                         iters=iters, max_corr=max_corr)
            out[(i, j)] = T
    return out


def load_scene_frames(scene_dir: str) -> List[Scan]:
    """All frames of a scene in (agent, numeric frame) order."""
    scans = []
    for agent in sorted(os.listdir(scene_dir)):
        adir = os.path.join(scene_dir, agent)
        if not os.path.isdir(adir):
            continue
        frames = [f for f in os.listdir(adir)
                  if os.path.splitext(f)[1] in (".npz", ".npy", ".bin",
                                                ".pcd")]
        frames.sort(key=lambda f: int("".join(ch for ch in
                                              os.path.splitext(f)[0]
                                              if ch.isdigit()) or 0))
        scans += [read_auto(os.path.join(adir, f)) for f in frames]
    if not scans:
        raise FileNotFoundError(f"no point-cloud frames under {scene_dir}")
    return scans


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", required=True)
    ap.add_argument("--output", default=None,
                    help="default <scene>/refined_SE3.pkl")
    ap.add_argument("--max_distance", type=float, default=20.0)
    ap.add_argument("--voxel", type=float, default=0.5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--max_corr", type=float, default=1.0)
    args = ap.parse_args(argv)

    scans = load_scene_frames(args.scene)
    print(f"{len(scans)} frames in {args.scene}")
    refined = refine_scene(scans, args.max_distance, args.voxel,
                           args.iters, args.max_corr)
    out = args.output or os.path.join(args.scene, "refined_SE3.pkl")
    with open(out, "wb") as f:
        pickle.dump(refined, f)
    print(f"wrote {len(refined)} pairwise SE3s -> {out}")


if __name__ == "__main__":
    main()
