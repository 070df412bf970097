"""Device-utilization (MFU) and roofline report of the PyTorch/CUDA port's
hot programs: the counterpart of scripts/mfu_profile.py.

    python scripts/mfu_profile_torch.py [--trials 30] [--train_step]
        [--trace DIR] [--json_out FILE] [--device cuda|cpu]
        [--model full|demo]

For each program (deeppointmap_tpu_torch/pipeline/mfu.py): its FLOPs from
deeppointmap_tpu_torch/utils/roofline.py (counted from shapes and this
run's inputs, the same whatever implements the program), its bytes (its
inputs, weights and state read once and its outputs written once; the
sum of its layers' traffic beside them as unfused GB), its steady time as
a chain of dependent calls ending in torch.cuda.synchronize(), and the
achieved rates as shares of the card's published peaks (`mfu`:
operations, `hbm_share`: bytes, `roofline_share`: the larger, by
`bound_by`), with the card's name and power limit. Programs, as scripts/mfu_profile.py's: extract (preprocess +
encoder, InferenceEngine._extract_impl), fused odometry (extract +
registration + information matrix, _odometry_impl), register 256v256 with
the information matrix (_register_info), and with --train_step one
stage-1 step of pipeline/full_size's trainer at S = 2 frames a group
(the JAX row's S). Every program runs under the config's `tpu.bf16` rule
for its device (utils/precision.py: "bfloat16" on a card under the
shipped configs, the network's products at the bfloat16 rate), which
each row names; chip_smoke.py's `mfu` phase adds the float32 rows.

--model full (default): DeepPointMap-B at configs/infer/sample.yaml's full
width (16384-point pad) with artifacts/full_size_occ_v2, on the first two
scans of the occluded synthetic stream (data/synthetic.render_stream, as
chip_smoke.py's main phase); the training step on the full-size recipe's
evaluation world under log_train/mfu/. --model demo: the engine programs
of the demo-width model (pipeline/demo.demo_args, artifacts/synthetic_demo,
2048-point pad) on the demo world's first two scans; --train_step takes
the full model only.

--device cpu runs each program once on the CPU (the kernels' plain
versions) for its count and prints every device field as null: no CPU
time is reported. --device cuda without a card raises. --trace DIR writes
a torch.profiler chrome trace of five fused odometry steps there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from deeppointmap_tpu_torch.pipeline import mfu  # noqa: E402
from deeppointmap_tpu_torch.utils import roofline  # noqa: E402

SAMPLE_YAML = os.path.join(REPO, "configs/infer/sample.yaml")
WEIGHTS = {"full": os.path.join(
    REPO, "artifacts/full_size_occ_v2/weights_final.msgpack"),
    "demo": os.path.join(REPO,
                         "artifacts/synthetic_demo/weights_final.msgpack")}
#: the demo world (pipeline/demo.write_world): frames of the 25 m circle
DEMO_FRAMES = 60


# ---------------------------------------------------------------- setup
def build_engine(model: str, device: str):
    """-> (args, engine, points (2, P, 3) raw meters, validity)."""
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.pipeline.infer import \
        device_preprocess_config
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    if model == "full":
        from deeppointmap_tpu_torch.config import config_from_yaml

        args = config_from_yaml(SAMPLE_YAML, device=device)
        pts, valid, _ = syn.pad_stream(syn.render_stream(2), 2,
                                       int(args.tpu.encoder_points))
    else:
        from deeppointmap_tpu_torch.pipeline.demo import (demo_args,
                                                          padded_scans)

        args = demo_args("", "")
        pts, valid = padded_scans(DEMO_FRAMES, 2,
                                  int(args.tpu.encoder_points))
    enc_sd, dec_sd = load_weights(args, WEIGHTS[model])
    engine = InferenceEngine(args, enc_sd, dec_sd, device=device,
                             preprocess_cfg=device_preprocess_config(args))
    return args, engine, pts, valid


def build_trainer(device: str):
    """-> (args, trainer, stage-1 batch): pipeline/full_size's training
    arguments on its evaluation world cut to one scene, the models from
    the served weights."""
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.pipeline import full_size
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.pipeline.train import training_transforms
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    root = os.path.join(REPO, "log_train", "mfu", "full")
    full_size.build_eval_world(os.path.join(root, "world"))
    args = full_size.full_train_args(os.path.join(root, "world"),
                                     os.path.join(root, "out"))
    args.dataset[0]["scenes"] = ["scene0"]
    rng = np.random.default_rng(0)
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    enc_sd, dec_sd = load_weights(args, WEIGHTS["full"])
    trainer = Trainer(args, ds, enc_sd, dec_sd, rng=rng, device=device)
    return args, trainer, mfu.stage1_batch(args, ds,
                                           int(args.tpu.encoder_points))


# ---------------------------------------------------------------- report
def print_table(rows, out=sys.stdout) -> None:
    fmt = lambda x, spec: "-" if x is None else format(x, spec)
    print(f"{'program':40s} {'ms':>8s} {'GFLOP':>8s} {'GB':>7s} "
          f"{'unfusedGB':>9s} {'TF/s':>7s} {'mfu':>8s} {'hbm':>8s} "
          f"{'roof':>8s} by / policy", file=out)
    for r in rows:
        print(f"{r['program']:40s} {fmt(r['ms'], '8.3f')} "
              f"{r['gflops']:8.3f} {r['gbytes']:7.4f} "
              f"{r['unfused_gbytes']:9.4f} "
              f"{fmt(r['achieved_tflops'], '7.3f')} {fmt(r['mfu'], '8.5f')} "
              f"{fmt(r['hbm_share'], '8.5f')} "
              f"{fmt(r['roofline_share'], '8.5f')} {r['bound_by'] or '-'} "
              f"{r['matmul_policy']}", file=out)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--train_step", action="store_true",
                    help="also one stage-1 training step (builds a trainer)")
    ap.add_argument("--trace", default="",
                    help="also a torch.profiler chrome trace of five fused "
                         "odometry steps in this directory")
    ap.add_argument("--json_out", default="",
                    help="write the rows as JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--model", default="full", choices=("full", "demo"))
    cli = ap.parse_args(argv)
    if cli.train_step and cli.model != "full":
        ap.error("--train_step takes the full-width model only")

    peaks, card = roofline.device_peaks(cli.device)
    if card is not None:
        from deeppointmap_tpu_torch import kernels

        kernels.strict_matmuls()
        print(f"card: {card}", file=sys.stderr)
    args, engine, pts, valid = build_engine(cli.model, cli.device)
    print(f"matmul policy: {engine.matmul_policy}", file=sys.stderr)
    programs = mfu.engine_programs(engine, pts, valid)
    with torch.inference_mode():
        rows = mfu.measure(programs, cli.trials, cli.device, peaks, card)
    if cli.train_step:
        targs, trainer, batch = build_trainer(cli.device)
        try:
            rows += mfu.measure([mfu.train_program(trainer, targs, batch)],
                                max(3, cli.trials // 3), cli.device, peaks,
                                card)
        finally:
            trainer.close()
    if cli.trace:
        os.makedirs(cli.trace, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if card is not None:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.inference_mode(), torch.profiler.profile(
                activities=acts) as prof:
            for _ in range(5):
                programs[1].call()
            if card is not None:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(cli.trace, "trace.json"))
        print(f"profiler trace written to {cli.trace}", file=sys.stderr)

    print_table(rows)
    print(f"peaks: {peaks._asdict() if peaks else None}; device: {card}")
    if cli.json_out:
        with open(cli.json_out, "w") as f:
            json.dump(dict(model=cli.model, device=card,
                           peaks=peaks._asdict() if peaks else None,
                           trials=cli.trials, rows=rows), f, indent=1)
        print(f"json report -> {cli.json_out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
