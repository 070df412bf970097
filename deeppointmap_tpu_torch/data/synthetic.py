"""Synthetic LiDAR world generator (testing / demo; port of
deeppointmap_tpu/data/synthetic.py, same draws for the same generator).

Builds a structured random world (clustered surfaces) and renders scans
from poses along a trajectory: world points within sensor range,
expressed in the scan frame. Scans of nearby poses overlap consistently,
so registration/loop models can actually be TRAINED on this data -- the
end-to-end suites use it to demonstrate learn -> SLAM -> loop closure
without any external dataset."""

from __future__ import annotations

import os
from typing import List, Tuple

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
    world = np.concatenate(clouds, 0).astype(np.float32)
    return world


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
    """World points within range, transformed into the scan frame.

    `occlusion_bins` > 0 enables first-return occlusion: points are
    binned by (azimuth, elevation) from the sensor into a spherical
    z-buffer of `occlusion_bins` azimuth x `occlusion_bins // 16`
    elevation cells, and only points within `occlusion_depth` meters of
    the nearest return in their cell survive -- like a LiDAR, a wall
    shadows everything behind it. This makes VISIBILITY viewpoint-
    dependent: far-apart poses see different subsets of the same world,
    which is what gives the stage-2 overlap/loop label its signal
    (without it, every scan of a compact world sees most of the world
    and the label is uninformative -- BASELINE.md round-3 notes)."""
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
        # elevation span of a ground vehicle sensor: steep up-looks are
        # rare; clip to [-30 deg, +45 deg]
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


def write_npz_sequence(root: str, world: np.ndarray,
                       poses: List[np.ndarray],
                       rng: np.random.Generator | None = None,
                       agent: str = os.path.join("scene0", "0"),
                       **render_kw) -> str:
    """Write the rendered sequence as an npz scene usable by both
    SlamDatasets (training) and BasicAgent (inference)."""
    rng = rng or np.random.default_rng(0)
    agent_dir = os.path.join(root, agent)
    os.makedirs(agent_dir, exist_ok=True)
    for i, pose in enumerate(poses):
        xyz = render_scan(world, pose, rng=rng, **render_kw)
        np.savez(os.path.join(agent_dir, f"{i}.npz"),
                 lidar_pcd=xyz,
                 ego_rotation=pose[:3, :3].astype(np.float32),
                 ego_translation=pose[:3, 3:].astype(np.float32))
    return agent_dir


# The occluded stream that chip_smoke.py and bench_torch.py drive: the world,
# render and lap of artifacts/full_size_occ_v2/render_meta.json (the JAX
# package's accuracy world, scripts/train_full_size.py build_eval_world),
# seed 0, rendered in memory and written as KITTI .bin files or npz scans.
STREAM_SEED = 0
STREAM_WORLD = dict(n_clusters=1200, extent=120.0, pts_per_cluster=800)
STREAM_RENDER = dict(sensor_range=45.0, max_points=16384, occlusion_bins=512)
STREAM_TRAJ = dict(radius=50.0, frames_per_lap=96)


def render_stream(n_frames: int):
    """n_frames raw-meter scans (a list of (n_i, 3) arrays) along the
    stream's circle, lap after lap, and their ground-truth poses."""
    rng = np.random.default_rng(STREAM_SEED)
    world = make_world(rng, **STREAM_WORLD)
    lap = circle_trajectory(STREAM_TRAJ["frames_per_lap"],
                            STREAM_TRAJ["radius"])
    poses = [lap[i % len(lap)] for i in range(n_frames)]
    return [render_scan(world, p, rng=rng, **STREAM_RENDER)
            for p in poses], poses


def pad_stream(raw, n_frames: int, n_pad: int = 16384):
    """The first n_frames scans of `raw` (render_stream's pair) voxelized
    at 0.3 m ('first' retention) and padded: (n_frames, n_pad, 3) raw meters,
    validity (n_frames, n_pad) and the ground-truth poses."""
    from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices

    scans, poses = raw
    pts = np.zeros((n_frames, n_pad, 3), np.float32)
    valid = np.zeros((n_frames, n_pad), bool)
    for i in range(n_frames):
        keep = voxel_downsample_indices(scans[i], 0.3, "first")
        xyz = scans[i][keep][:n_pad]
        pts[i, :len(xyz)] = xyz
        valid[i, :len(xyz)] = True
    return pts, valid, poses[:n_frames]


def write_bins(scans, root: str) -> str:
    """Scans as KITTI velodyne files (N, 4) float32 x/y/z/intensity."""
    os.makedirs(root, exist_ok=True)
    for i, xyz in enumerate(scans):
        np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)],
                       1).astype(np.float32).tofile(
            os.path.join(root, f"{i:06d}.bin"))
    return root


def write_npz(scans, poses, root: str) -> str:
    """Scans with their ground-truth poses as an npz sequence, the layout
    of write_npz_sequence (which renders them itself)."""
    os.makedirs(root, exist_ok=True)
    for i, (xyz, pose) in enumerate(zip(scans, poses)):
        np.savez(os.path.join(root, f"{i}.npz"), lidar_pcd=xyz,
                 ego_rotation=pose[:3, :3].astype(np.float32),
                 ego_translation=pose[:3, 3:].astype(np.float32))
    return root
