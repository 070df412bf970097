"""The drive a cell's traffic names, rendered from the seed by the frozen
generator and cached under `benchmark/.cache/scans/<generator hash>/`:
one directory of npz scans a (seed, world, render, trajectory), written
once and then read by the program's own readers."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

from benchmark.gen import synthetic
from benchmark.lib.spec import BENCH

CACHE = os.path.join(BENCH, ".cache")


def _key(seed: int, world: dict, render: dict, traj: dict) -> str:
    blob = json.dumps([seed, world, render, traj], sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def drive_dir(seed: int, world: dict, render: dict, traj: dict) -> str:
    return os.path.join(CACHE, "scans", synthetic.generator_hash(),
                        _key(seed, world, render, traj))


def ensure_drive(seed: int, world: dict, render: dict, traj: dict,
                 workers: int = 8) -> str:
    """-> the directory of the drive's npz scans (`i.npz`), rendered with
    `workers` processes unless the cache holds it already."""
    root = drive_dir(seed, world, render, traj)
    done = root + ".done"
    if os.path.exists(done):
        return root
    shutil.rmtree(root, ignore_errors=True)
    scans, poses = synthetic.render_drive(seed, world, render, traj,
                                          workers=workers)
    synthetic.write_drive(scans, poses, root)
    with open(done, "w") as f:
        f.write(str(len(scans)))
    return root


def cyclic_view(root: str, offset: int) -> str:
    """A directory of links that presents the drive's scans from `offset`
    on, wrapping around: the same scans in another order."""
    names = sorted((f for f in os.listdir(root) if f.endswith(".npz")),
                   key=lambda f: int(f.split(".")[0]))
    n = len(names)
    offset %= n
    view = f"{root}.from{offset}"
    done = view + ".done"
    if os.path.exists(done):
        return view
    shutil.rmtree(view, ignore_errors=True)
    os.makedirs(view)
    for j in range(n):
        os.symlink(os.path.join(root, names[(offset + j) % n]),
                   os.path.join(view, f"{j}.npz"))
    with open(done, "w") as f:
        f.write(str(offset))
    return view


def load_scan(root: str, i: int):
    """-> (raw points (n, 3) float32, ground-truth pose (4, 4))."""
    with np.load(os.path.join(root, f"{i}.npz")) as z:
        pose = np.eye(4)
        pose[:3, :3] = z["ego_rotation"]
        pose[:3, 3] = z["ego_translation"][:, 0]
        return np.asarray(z["lidar_pcd"], np.float32), pose
