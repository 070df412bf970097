"""Result logging: perf counters, KITTI trajectory files, g2o (port of
deeppointmap_tpu/slam/recoder.py).

Byte-format parity with the reference ResultLogger (reference:
system/modules/recoder.py:24-243): `trajectory.allframes.txt` /
`.keyframes.txt` are KITTI 3x4 rows at 10 decimals, `.allsteps.txt` /
`.keysteps.txt` the matching timestep indices. The map render uses
matplotlib directly, imported where it draws (the reference also routes
through Open3D just to voxel-downsample for plotting; data/voxel does that
here)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeppointmap_tpu_torch.data.voxel import voxel_downsample
from deeppointmap_tpu_torch.slam.pose_graph import PoseGraph
from deeppointmap_tpu_torch.utils import se3 as se3m


class ResultLogger:
    def __init__(self, args, system_info, posegraph_map: PoseGraph,
                 log_dir: str):
        self.args = args
        self.system_info = system_info
        self.log_dir = log_dir
        self.posegraph_map = posegraph_map
        self.time_recorder: Dict[str, List[float]] = {}

    def interp_pose(self, timestamp: float) -> np.ndarray:
        """Cubic-spline position interpolation from the latest poses
        (reference: recoder.py:44-55). Returns (3,) position."""
        from scipy.interpolate import CubicSpline

        pairs = sorted(
            ((s.timestamp, s.SE3_pred[:3, 3])
             for s in self.posegraph_map.get_all_scans()
             if s.SE3_pred is not None),
            key=lambda tp: tp[0])[-3:]
        if len(pairs) == 1:
            return pairs[0][1]
        xs = [t for t, _ in pairs]
        ys = np.stack([p for _, p in pairs], 0)
        if len(pairs) == 2:  # spline needs >= 3 knots; fall back to linear
            a = (timestamp - xs[0]) / max(xs[1] - xs[0], 1e-9)
            return (1 - a) * ys[0] + a * ys[1]
        return CubicSpline(xs, ys, axis=0)([timestamp])[0]

    # ------------------------------------------------------------- perf
    def record_perf(self, name: str, time_s: float) -> None:
        self.time_recorder.setdefault(name, []).append(time_s)

    def log_time(self, window: Optional[int] = None
                 ) -> Dict[str, Tuple[float, float]]:
        out = {}
        for name, times in self.time_recorder.items():
            t = ([x for x in times if x > 0.0] if window is None
                 else times[-window:])
            if t:
                out[name] = (sum(t) / len(t), float(np.std(t)))
        return out

    def get_time_list(self, name: str) -> List[float]:
        return self.time_recorder[name].copy()

    # ------------------------------------------------------- trajectories
    def save_trajectory(self, file_name: str = "trajectory") -> None:
        scans = sorted(self.posegraph_map.get_all_scans(),
                       key=lambda s: s.timestep)

        def rows(seq):
            return "".join(
                " ".join(f"{v:.10f}" for v in s.SE3_pred[:3, :].flatten())
                + "\n" for s in seq)

        def steps(seq):
            return "".join(f"{int(s.timestep)}\n" for s in seq)

        keyframes = [s for s in scans if s.type == "full"]
        j = lambda n: os.path.join(self.log_dir, f"{file_name}.{n}.txt")
        with open(j("allframes"), "w+") as f:
            f.write(rows(scans))
        with open(j("allsteps"), "w+") as f:
            f.write(steps(scans))
        with open(j("keyframes"), "w+") as f:
            f.write(rows(keyframes))
        with open(j("keysteps"), "w+") as f:
            f.write(steps(keyframes))

    def save_posegraph(self, file_name: str = "posegraph") -> None:
        self.posegraph_map.to_g2o_file(
            os.path.join(self.log_dir, file_name + ".pg.g2o"))

    # ------------------------------------------------------------ render
    def draw_trajectory(self, file_name: str = "trajectory",
                        draft: bool = False) -> None:
        """Trajectory + map render to `<file_name>.map.jpg` (reference:
        recoder.py:99-203). matplotlib is imported here, so a machine
        without it raises ImportError, which callers log."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        face = (0.075, 0.075, 0.075, 1)
        if draft:
            plt.figure(figsize=(10, 10), facecolor=face)
        else:
            plt.figure(figsize=(20, 20), dpi=150, facecolor=face)
        ax = plt.axes()
        ax.axis("equal")
        ax.set_facecolor(face)
        cmap = plt.get_cmap("tab20")
        color = lambda aid: cmap(2 * aid + 1)[:3]

        scans = sorted(self.posegraph_map.get_all_scans(),
                       key=lambda s: s.timestep)
        for s in scans:
            if s.SE3_pred is None:
                continue
            marker = "o" if s.type == "full" else ","
            alpha = 1.0 if s.type == "full" else 0.3
            ax.plot(s.SE3_pred[0, 3], s.SE3_pred[1, 3],
                    color=color(s.agent_id), markersize=5, linestyle="",
                    marker=marker, alpha=alpha, zorder=10)
            if s.SE3_gt is not None:
                ax.scatter(s.SE3_gt[0, 3], s.SE3_gt[1, 3], marker=".",
                           c="white", zorder=9)
        edge_colors = {"locz": ("lime", 0.5, 8), "loop": ("yellow", 0.75, 20),
                       "odom": ("cyan", 0.75, 8), "prxy": ("purple", 0.75, 8)}
        for e in self.posegraph_map.get_all_edges():
            s0 = self.posegraph_map.get_scanpack(e.src_scan_token).SE3_pred
            s1 = self.posegraph_map.get_scanpack(e.dst_scan_token).SE3_pred
            c, a, z = edge_colors[e.type]
            ax.plot([s0[0, 3], s1[0, 3]], [s0[1, 3], s1[1, 3]],
                    color=c, alpha=a, zorder=z)

        cloud = None if draft else self.world_cloud()
        if cloud is not None:
            # the global map, voxel-downsampled at 0.5 m for plotting (the
            # reference uses Open3D for this step: recoder.py:180,190)
            cloud = voxel_downsample(cloud, 0.5)
            ax.scatter(cloud[:, 0], cloud[:, 1], s=0.5,
                       color=color(self.posegraph_map.agent_id),
                       alpha=0.25, zorder=4)
        plt.tight_layout()
        plt.savefig(os.path.join(self.log_dir, file_name + ".map.jpg"))
        plt.close()

    def world_cloud(self) -> Optional[np.ndarray]:
        """The valid points of every scan that holds a cloud, moved into the
        world frame by its pose: (N, 3) float32, or None."""
        clouds = []
        for s in self.posegraph_map.get_all_scans():
            if s.full_pcd is None or s.SE3_pred is None:
                continue
            R, t = se3m.rt(s.SE3_pred)
            clouds.append(s.full_pcd[s.full_valid][:, :3] @ R.T + t.reshape(1, 3))
        if not clouds:
            return None
        return np.concatenate(clouds, 0).astype(np.float32)

    def save_map(self, file_name: str = "map") -> None:
        """World-frame merged cloud -> .npz (the reference's PCD writers are
        commented out, recoder.py:221-239; npz is the native format here)."""
        cloud = self.world_cloud()
        if cloud is not None:
            np.savez_compressed(
                os.path.join(self.log_dir, file_name + ".fullpoints.npz"),
                points=cloud)
