#!/usr/bin/env python3
"""Where the time of the port's step goes, on one CUDA device.

    python3 scripts/profile_torch_step.py [--path engine|slam|train]
                                          [--steps 5] [--warm 24] [--out DIR]

`--path engine` builds the engine of chip_smoke.py (DeepPointMap-B, device
preprocessing, int16 upload, info matrix at stride 4) on the same synthetic
scans and times `--steps` odometry steps after a warm-up. `--path slam`
times `SlamSystem.step` as chip_smoke.py's slam_a runs it (scans read from
KITTI .bin files, tpu.sweep_reuse and USE_FUSED_SWEEP, the same edge gates)
after `--warm` steps that build up a map; the scans are read and voxelized
before the clock starts. `--path train` times stage-1 training steps of
chip_smoke.py's train phase (its scene, its full_train_args copy, warm-started
from the trained weights) on batches built before the clock starts, after
two warm-up steps; the step code is the step's frame count (B*S). A third
pass builds each batch on the host right before its step, as the CLI does,
and reports the host's and the step's ms apart.

The same frames run twice from the same start (the slam path builds a fresh
SlamSystem and empties the engine's cache; the step codes of the two passes
must be equal): first without the profiler, on the host clock (each step
ends in a copy to the host), then with one torch.profiler trace around
each step, so that every step has its own device kernel time and launch
count. The busy share of a step is its device kernel time over its wall time
from the pass without the profiler (the profiler's own overhead grows with
the launch count; overlapping kernels would count twice, and the step runs
on one stream).

Prints one JSON line: per step its code (slam path: `acpt` is a keyframe
step with scan-to-map registration and the loop check), wall ms, traced wall
ms, device ms and launches; the means over all steps and per step code; the
kernel time of K1 (fps), K2 (knn), K3 (moments) and K4 (sweep) a step; and
the kernels with the most device time. With --out, writes the same to
DIR/profile_step.json (profile_slam.json, profile_train.json for the other
paths).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

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
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("engine", "slam", "train"),
                    default="engine")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warm", type=int, default=24,
                    help="slam path: steps before the timed ones")
    ap.add_argument("--out", default="")
    opts = ap.parse_args()
    steps = opts.steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    if opts.path == "engine":
        args = config_from_dict(cs.CONFIG)
        pts, valid, _ = syn.pad_stream(syn.render_stream(cs.N_FRAMES),
                                       cs.N_FRAMES, cs.N_PAD)
        engine = InferenceEngine(
            args, *load_msgpack_weights(cs.WEIGHTS),
            preprocess_cfg=PreprocessConfig.from_transforms(args.transforms),
            device="cuda")
        warm = [1, 2]
        order = [3 + j % (len(pts) - 3) for j in range(steps)]

        def start():
            prev = engine.extract(pts[:1], valid[:1])

            def step(i):
                nonlocal prev
                out = engine.odometry_step(pts[i:i + 1], valid[i:i + 1],
                                           prev[0][0], prev[1][0],
                                           pts[i - 1], prev[2][0])
                prev = out[:3]
                return "step"
            return step
    elif opts.path == "train":
        from deeppointmap_tpu_torch.data.dataset import SlamDatasets
        from deeppointmap_tpu_torch.pipeline.train import training_transforms
        from deeppointmap_tpu_torch.pipeline.trainer import Trainer

        tmp = tempfile.TemporaryDirectory()
        cs.render_train_scene(syn, tmp.name + "/world")
        args = config_from_dict(cs.train_config(tmp.name + "/world",
                                                tmp.name + "/log"))
        enc_sd, dec_sd = load_msgpack_weights(cs.WEIGHTS)

        def trainer():
            rng = np.random.default_rng(0)
            return Trainer(args, SlamDatasets(
                args, data_transforms=training_transforms(args, rng),
                rng=rng), enc_sd, dec_sd, rng=rng, device="cuda")

        it = trainer()._iter_batches()
        batches = [next(it) for _ in range(2 + steps)]
        warm = [0, 1]
        order = list(range(2, 2 + steps))

        def start():
            tr = trainer()

            def step(i):
                tr.train_step(batches[i])
                return str(batches[i].points.shape[0]
                           * batches[i].points.shape[1])
            return step
    else:
        from deeppointmap_tpu_torch.data.dataset import BasicAgent
        from deeppointmap_tpu_torch.ops import normals
        from deeppointmap_tpu_torch.pipeline import infer
        from deeppointmap_tpu_torch.slam.system import SlamSystem

        cs.CONFIG["slam_system"].update(cs.SYNTHETIC_GATES)
        args = config_from_dict(cs.CONFIG, multi_thread=False)
        args.tpu.sweep_reuse = True
        normals.USE_FUSED_SWEEP = True
        n_frames = opts.warm + steps
        tmp = tempfile.TemporaryDirectory()
        syn.write_bins(syn.render_stream(n_frames)[0], tmp.name + "/seq")
        engine = InferenceEngine(
            args, *load_msgpack_weights(cs.WEIGHTS),
            preprocess_cfg=infer.device_preprocess_config(args),
            device="cuda")
        agent = BasicAgent(root=tmp.name + "/seq", reader="auto")
        agent.set_independent(infer.make_infer_transform(args))
        data = [agent[i] for i in range(n_frames)]
        warm = list(range(opts.warm))
        order = list(range(opts.warm, n_frames))
        passes = iter("ab")

        def start():
            engine.invalidate_device_cache()
            system = SlamSystem(args, engine, system_id=1,
                                logger_dir=f"{tmp.name}/out_{next(passes)}")
            return lambda i: system.step(data[i]).name

    # pass 1: the host clock, no profiler
    step = start()
    for i in warm:
        step(i)
    codes, plain_wall = [], []
    for i in order:
        t0 = time.perf_counter()
        codes.append(step(i))
        plain_wall.append((time.perf_counter() - t0) * 1e3)

    # pass 2: the same frames, one profiler trace a step
    step = start()
    for i in warm:
        step(i)
    by_name = defaultdict(lambda: [0.0, 0])
    wall, device, launches, traced_codes = [], [], [], []
    for i in order:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            traced_codes.append(step(i))
            wall.append((time.perf_counter() - t0) * 1e3)
        ms, n = 0.0, 0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name][0] += ev.device_time / 1e3     # us -> ms
                by_name[ev.name][1] += 1
                ms += ev.device_time / 1e3
                n += 1
        device.append(ms)
        launches.append(n)
    if traced_codes != codes:
        raise AssertionError(f"the two passes took different decisions: "
                             f"{codes} {traced_codes}")
    if opts.path == "train":
        # pass 3, as the CLI runs: the host builds each batch right before
        # its step (host ms beside the step's wall ms, no profiler)
        tr = trainer()
        it = tr._iter_batches()
        batch_ms, step_ms = [], []
        for j in range(2 + steps):
            t0 = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            tr.train_step(batch)
            if j >= 2:
                batch_ms.append((t1 - t0) * 1e3)
                step_ms.append((time.perf_counter() - t1) * 1e3)

    mean = lambda xs: sum(xs) / len(xs)
    by_code = {}
    for code in sorted(set(codes)):
        sel = [j for j, c in enumerate(codes) if c == code]
        w, d = mean([plain_wall[j] for j in sel]), mean(
            [device[j] for j in sel])
        by_code[code] = dict(steps=len(sel), wall_ms=w, device_ms=d,
                             launches=mean([launches[j] for j in sel]),
                             device_busy_share=d / w)
    share = lambda key: sum(v[0] for n, v in by_name.items()
                            if key in n) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    out = dict(card=smi, path=opts.path, steps=steps, step_codes=codes,
               wall_ms=plain_wall, wall_ms_per_step=mean(plain_wall),
               traced_wall_ms=wall, device_kernel_ms=device,
               launches=launches,
               device_kernel_ms_per_step=mean(device),
               device_busy_share=mean(device) / mean(plain_wall),
               by_code=by_code,
               fps_kernel_ms_per_step=share("fps_kernel"),
               knn_kernel_ms_per_step=share("knn_kernel")
               + share("pack_kernel"),     # K2's packing pass is K2's
               moments_kernel_ms_per_step=share("moments_kernel"),
               sweep_kernel_ms_per_step=share("sweep_kernel"),
               kernels_per_step=mean(launches),
               top=[dict(name=n[:90], ms_per_step=v[0] / steps,
                         calls_per_step=v[1] / steps) for n, v in top])
    if opts.path == "train":
        out["batches_built_between_steps"] = dict(
            batch_ms=batch_ms, step_ms=step_ms,
            step_ms_per_step=mean(step_ms))
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        name = {"engine": "profile_step.json", "slam": "profile_slam.json",
                "train": "profile_train.json"}[opts.path]
        with open(os.path.join(opts.out, name), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
