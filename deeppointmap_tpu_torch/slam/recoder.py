"""Result logging: perf counters, KITTI trajectory files, g2o (port of
deeppointmap_tpu/slam/recoder.py).

Byte-format parity with the reference ResultLogger (reference:
system/modules/recoder.py:24-243): `trajectory.allframes.txt` /
`.keyframes.txt` are KITTI 3x4 rows at 10 decimals, `.allsteps.txt` /
`.keysteps.txt` the matching timestep indices. The map render is not
ported yet."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

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
        """Trajectory + map render (reference: recoder.py:99-203): not
        ported yet, it comes with utils/visualization in a later slice of
        the port. Callers treat a failed render as a warning."""
        raise NotImplementedError(
            "draw_trajectory is not ported yet (it arrives with "
            "utils/visualization in a later slice of the port)")

    def save_map(self, file_name: str = "map") -> None:
        """World-frame merged cloud -> .npz (the reference's PCD writers are
        commented out, recoder.py:221-239; npz is the native format here)."""
        clouds = []
        for s in self.posegraph_map.get_all_scans():
            if s.full_pcd is None or s.SE3_pred is None:
                continue
            R, t = se3m.rt(s.SE3_pred)
            clouds.append(s.full_pcd[s.full_valid][:, :3] @ R.T + t.reshape(1, 3))
        if clouds:
            np.savez_compressed(
                os.path.join(self.log_dir, file_name + ".fullpoints.npz"),
                points=np.concatenate(clouds, 0).astype(np.float32))
