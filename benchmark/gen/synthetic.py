"""The benchmark's frozen scan generator: a structured random world and
its LiDAR render along a circle (a copy of deeppointmap_tpu_torch/data/
synthetic.py's `make_world`, `se3`, `circle_trajectory` and `render_scan`
as they stood when the benchmark was defined; benchmark/tests/
test_bench_frozen.py pins them to the port's). The program may change its
own generator; the benchmark's traffic does not move with it.

`render_drive` draws the world from its own seed and each scan from its
own generator ([render seed, 1, frame]), so that the scans can be
rendered in any order, or by several processes, and come out the same.
NumPy only.
"""

from __future__ import annotations

import hashlib
import inspect
import os
from typing import List

import numpy as np


def make_world(rng: np.random.Generator, n_clusters: int = 60,
               extent: float = 60.0, pts_per_cluster: int = 400
               ) -> np.ndarray:
    """Clustered world cloud (N, 3): vertical planes + boxes + scatter."""
    clouds = []
    for _ in range(n_clusters):
        center = rng.uniform(-extent, extent, 3)
        center[2] = rng.uniform(0, 4)
        kind = rng.integers(0, 3)
        if kind == 0:      # vertical plane patch
            u = rng.normal(size=3)
            u[2] = 0
            u /= np.linalg.norm(u) + 1e-9
            s = rng.uniform(1, 6)
            a = rng.uniform(-s, s, pts_per_cluster)
            b = rng.uniform(0, 4, pts_per_cluster)
            pts = center + a[:, None] * u + b[:, None] * np.array([0, 0, 1.0])
        elif kind == 1:    # box corner
            s = rng.uniform(0.5, 3)
            pts = center + rng.uniform(-s, s, (pts_per_cluster, 3)) \
                * np.array([1, 1, 0.5])
        else:              # scatter blob (vegetation)
            pts = center + rng.normal(0, 1.2, (pts_per_cluster, 3))
        clouds.append(pts)
    return np.concatenate(clouds, 0).astype(np.float32)


def se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Assemble a 4x4 float64 SE3 from a rotation and a translation."""
    mat = np.eye(4, dtype=np.float64)
    mat[:3, :3] = np.asarray(R, dtype=np.float64).reshape(3, 3)
    mat[:3, 3] = np.asarray(t, dtype=np.float64).reshape(3)
    return mat


def circle_trajectory(n: int, radius: float = 25.0) -> List[np.ndarray]:
    """SE3 poses around a closed circle, heading tangent."""
    poses = []
    for k in range(n):
        a = 2 * np.pi * k / n
        heading = a + np.pi / 2
        R = np.array([[np.cos(heading), -np.sin(heading), 0],
                      [np.sin(heading), np.cos(heading), 0],
                      [0, 0, 1.0]])
        t = np.array([radius * np.cos(a), radius * np.sin(a), 1.5])
        poses.append(se3(R, t))
    return poses


def render_scan(world: np.ndarray, pose: np.ndarray,
                sensor_range: float = 35.0, noise: float = 0.02,
                max_points: int = 4000,
                rng: np.random.Generator | None = None,
                occlusion_bins: int = 0,
                occlusion_depth: float = 0.6) -> np.ndarray:
    """World points within range, in the scan frame; with
    `occlusion_bins` > 0 only first returns of a spherical z-buffer
    (`occlusion_bins` azimuth x `occlusion_bins // 16` elevation cells)
    survive, within `occlusion_depth` m of the nearest return."""
    rng = rng or np.random.default_rng(0)
    t = pose[:3, 3]
    d = np.linalg.norm(world - t, axis=1)
    near = world[d < sensor_range]
    local = (near - t) @ pose[:3, :3]     # R^T (p - t)
    if occlusion_bins > 0 and local.shape[0] > 0:
        r = np.linalg.norm(local, axis=1)
        az = np.arctan2(local[:, 1], local[:, 0])          # [-pi, pi)
        el = np.arcsin(np.clip(local[:, 2] / np.maximum(r, 1e-9), -1, 1))
        n_az = int(occlusion_bins)
        n_el = max(int(occlusion_bins) // 16, 8)
        ai = np.clip(((az + np.pi) / (2 * np.pi) * n_az).astype(np.int64),
                     0, n_az - 1)
        lo, hi = -np.pi / 6, np.pi / 4
        ei = np.clip(((el - lo) / (hi - lo) * n_el).astype(np.int64),
                     0, n_el - 1)
        key = ai * n_el + ei
        nearest = np.full(n_az * n_el, np.inf, np.float64)
        np.minimum.at(nearest, key, r)
        local = local[r <= nearest[key] + occlusion_depth]
    if local.shape[0] > max_points:
        local = local[rng.choice(local.shape[0], max_points, replace=False)]
    return (local + rng.normal(0, noise, local.shape)).astype(np.float32)


# ------------------------------------------------------------- drives
def generator_hash() -> str:
    """A hash of this module's render code: the scan cache's key, so that
    a changed generator never reads an old cache."""
    src = "".join(inspect.getsource(f) for f in (
        make_world, se3, circle_trajectory, render_scan, drive_poses,
        world_for, _render_one))
    return hashlib.sha1(src.encode()).hexdigest()[:12]


def drive_poses(traj: dict) -> List[np.ndarray]:
    """The drive's poses: `laps` laps of `frames_per_lap` frames on a
    circle of `radius` m (driven backwards with `direction` -1)."""
    lap = circle_trajectory(int(traj["frames_per_lap"]),
                            float(traj["radius"]))
    if int(traj.get("direction", 1)) < 0:
        lap = lap[::-1]
    return [lap[i % len(lap)] for i in range(len(lap) * int(traj["laps"]))]


def world_for(world: dict) -> np.ndarray:
    """The world of `world` (`seed`, `n_clusters`, `extent`,
    `pts_per_cluster`), drawn from its own seed."""
    world = dict(world)
    return make_world(np.random.default_rng(int(world.pop("seed"))), **world)


def _render_one(world, pose, seed: int, frame: int, render: dict):
    return render_scan(world, pose, rng=np.random.default_rng(
        [seed, 1, frame]), **render)


_WORKER: dict = {}


def _init_worker(world, poses, seed, render):
    _WORKER.update(world=world, poses=poses, seed=seed, render=render)


def _render_chunk(frames):
    w = _WORKER
    return [(i, _render_one(w["world"], w["poses"][i], w["seed"], i,
                            w["render"])) for i in frames]


def render_drive(seed: int, world: dict, render: dict, traj: dict,
                 workers: int = 1):
    """-> (scans: list of (n_i, 3) float32 raw-meter clouds, poses) of the
    drive rendered from `seed`; the same seed gives the same scans
    whatever `workers` is. Workers are spawned processes."""
    seed = int(seed) % (1 << 63)
    w = world_for(world)
    poses = drive_poses(traj)
    n = len(poses)
    if workers <= 1:
        return [_render_one(w, p, seed, i, render)
                for i, p in enumerate(poses)], poses
    import multiprocessing as mp

    chunks = [list(range(k, n, workers)) for k in range(workers)]
    ctx = mp.get_context("spawn")
    out = [None] * n
    with ctx.Pool(workers, initializer=_init_worker,
                  initargs=(w, poses, seed, render)) as pool:
        for part in pool.imap_unordered(_render_chunk, chunks):
            for i, scan in part:
                out[i] = scan
    return out, poses


def write_drive(scans, poses, root: str) -> str:
    """The scans with their poses as an npz sequence (`i.npz`: lidar_pcd,
    ego_rotation, ego_translation), the layout the port's readers take."""
    os.makedirs(root, exist_ok=True)
    for i, (xyz, pose) in enumerate(zip(scans, poses)):
        np.savez(os.path.join(root, f"{i}.npz"), lidar_pcd=xyz,
                 ego_rotation=pose[:3, :3].astype(np.float32),
                 ego_translation=pose[:3, 3:].astype(np.float32))
    return root
