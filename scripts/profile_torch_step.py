#!/usr/bin/env python3
"""Where the time of the port's odometry step goes, on one CUDA device.

    python3 scripts/profile_torch_step.py [--steps 5] [--out DIR]

Builds the engine of chip_smoke.py (DeepPointMap-B, device preprocessing,
int16 upload, info matrix at stride 4) on the same synthetic scans, warms
it up, then traces `--steps` odometry steps with torch.profiler. Prints one
JSON line: wall ms per step (host clock, each step ends in a copy to the
host), device kernel ms per step, the device's busy share (kernel time /
wall time; overlapping kernels would count twice, and the step runs on
one stream), the kernel time of K1 (fps) and K2 (knn), and the kernels
with the most device time; with --out, writes the same to
DIR/profile_step.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
    from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="")
    opts = ap.parse_args()
    steps = opts.steps

    args = config_from_dict(cs.CONFIG)
    pts, valid, _ = cs.render_scans(syn, voxel_downsample_indices)
    engine = InferenceEngine(args, *load_msgpack_weights(cs.WEIGHTS),
                             preprocess_cfg=PreprocessConfig.from_transforms(
                                 args.transforms), device="cuda")
    prev = engine.extract(pts[:1], valid[:1])

    def step(i):
        nonlocal prev
        out = engine.odometry_step(pts[i:i + 1], valid[i:i + 1], prev[0][0],
                                   prev[1][0], pts[i - 1], prev[2][0])
        prev = out[:3]

    for i in range(1, 3):                       # warm-up
        step(i)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wall = []
    with torch.profiler.profile(activities=acts) as prof:
        for j in range(steps):
            t0 = time.perf_counter()
            step(3 + j % (len(pts) - 3))
            wall.append((time.perf_counter() - t0) * 1e3)

    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.device_time / 1e3     # us -> ms
            by_name[ev.name][1] += 1
    device_ms = sum(v[0] for v in by_name.values()) / steps
    share = lambda key: sum(v[0] for n, v in by_name.items()
                            if key in n) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    out = dict(card=smi, steps=steps, wall_ms_per_step=sum(wall) / steps,
               wall_ms=wall, device_kernel_ms_per_step=device_ms,
               device_busy_share=device_ms / (sum(wall) / steps),
               fps_kernel_ms_per_step=share("fps_kernel"),
               knn_kernel_ms_per_step=share("knn_kernel"),
               kernels_per_step=sum(v[1] for v in by_name.values()) / steps,
               top=[dict(name=n[:90], ms_per_step=v[0] / steps,
                         calls_per_step=v[1] / steps) for n, v in top])
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, "profile_step.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
