"""Train -> export -> serve at DeepPointMap-B full width with the port, in
one process, and write what it measured as one JSON file.

    python scripts/full_size_card_run.py [--out chiprun_out/full_size]

1. Renders the six training worlds of deeppointmap_tpu_torch/pipeline/
   full_size.py (timed apart from training) and trains the compact recipe
   from scratch through scripts/train_full_size_torch.py's `train` (seed
   0, 12 + 4 epochs): per epoch the mean loss and top1_acc (stage 2: acc,
   precision, recall), the median seconds a step, the host's share
   (batch building over the whole step), the peak allocated device memory
   so far, K and the frames a step, and K1 / K2 launches a step by shape,
   from the trainer's steps.jsonl; each stage's wall time.
2. Evaluates on the held-out two-lap world, loops on and off
   (`full_size.evaluate`): (a) the weights it trained, (b) --reference
   (default artifacts/full_size, the JAX package's model of the same
   recipe) through the port, on the same card.
3. Writes (a) in the reference's .pth schema (`save_torch_weight`),
   checks that `pipeline.common.load_weights` reads it back to the same
   state dicts bit for bit, evaluates it again and compares the
   trajectory files (every pose, keyframe and edge) with (a)'s, byte for
   byte.

The report goes to OUT/full_size_run.json, rewritten after each step; the
trained weights, render_meta.json and steps.jsonl.gz go to OUT too.
`--also` evaluates more models beside them (an earlier run of the recipe, for the
spread between runs); `--trimmed` evaluates every model once more with
the trimmed Kabsch solve (`tpu.robust_register` off) under the same gates.
`--occlusion` trains the occlusion recipe (use `--init_weights`,
`--epochs1 24 --epochs2 8` and `--reference` the occluded artifact).
`--scenes`, `--frames` and `--eval_frames_per_lap` cut the recipe for a
dry run on the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import collections
import filecmp
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

import train_full_size_torch as tfs  # noqa: E402
from deeppointmap_tpu_torch.pipeline import full_size as fs  # noqa: E402

TRAJECTORY_FILES = ("trajectory.allframes.txt", "trajectory.allsteps.txt",
                    "trajectory.keyframes.txt", "trajectory.keysteps.txt",
                    "trajectory.pg.g2o")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def epoch_table(steps_path: str, args) -> list:
    """steps.jsonl -> one row an epoch (K: the curriculum's, stage 1)."""
    with open(steps_path) as f:
        rows = [json.loads(x) for x in f]
    table = []
    for (stage, epoch), group in _groups(rows):
        tail = group[1:] or group
        total = [r["batch_s"] + r["step_s"] for r in tail]
        keys = ("loss", "top1_acc") if stage == 1 else \
            ("loss", "acc", "precision", "recall")
        frames = collections.Counter(_frames(r) for r in group)
        launches = collections.Counter()
        for r in group:
            for name, sh, c in r["launches"]:
                launches[f"{name}{sh}"] += c
        reg = args.train.registration
        k = min(int(reg.K_0 * reg.K_mult ** (epoch // reg.mult_epoch)),
                int(reg.K_max)) if stage == 1 else None
        table.append(dict(
            stage=stage, epoch=epoch, K=k, steps=len(group),
            mean={k: float(np.mean([r["metrics"][k] for r in group]))
                  for k in keys},
            sec_per_step_median=float(np.median(total)),
            host_share=sum(r["batch_s"] for r in tail) / sum(total),
            peak_bytes=max(r["peak_bytes"] or 0 for r in group),
            frames_per_step={str(k): v for k, v in sorted(frames.items())},
            launches_per_step={k: c / len(group)
                               for k, c in sorted(launches.items())}))
    return table


def _groups(rows):
    out = collections.OrderedDict()
    for r in rows:
        out.setdefault((r["stage"], r["epoch"]), []).append(r)
    return out.items()


def _frames(row) -> int:
    """Frames a step encodes: the batch of its first-level FPS launch."""
    return max((sh[0] for name, sh, _ in row["launches"] if name == "fps"),
               default=0)


def same_state(a, b) -> bool:
    return all(x.keys() == y.keys() and all(
        x[k].dtype == y[k].dtype and bool((x[k] == y[k]).all()) for k in x)
        for x, y in zip(a, b))


def main(argv=None) -> dict:
    import logging

    import torch

    from deeppointmap_tpu_torch.config import config_from_yaml
    from deeppointmap_tpu_torch.models.weights import save_torch_weight
    from deeppointmap_tpu_torch.pipeline.common import load_weights

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "chiprun_out/full_size"))
    ap.add_argument("--work", default=os.path.join(REPO, "log_train/card"))
    ap.add_argument("--epochs1", type=int, default=12)
    ap.add_argument("--epochs2", type=int, default=4)
    ap.add_argument("--reference",
                    default=os.path.join(
                        REPO, "artifacts/full_size/weights_final.msgpack"),
                    help="the yardstick model ('' = none)")
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=WEIGHTS: another model to evaluate")
    ap.add_argument("--trimmed", action="store_true",
                    help="also evaluate with tpu.robust_register off")
    ap.add_argument("--occlusion", action="store_true")
    ap.add_argument("--init_weights", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scenes", type=int, default=len(fs.TRAIN_SCENES))
    ap.add_argument("--frames", type=int, default=fs.FRAMES_PER_SCENE)
    ap.add_argument("--eval_frames_per_lap", type=int, default=None)
    ns = ap.parse_args(argv)
    os.makedirs(ns.out, exist_ok=True)
    report_path = os.path.join(ns.out, "full_size_run.json")
    report = dict(card=card_line(), torch=torch.__version__,
                  cuda=torch.version.cuda, device=ns.device,
                  recipe=dict(scenes=ns.scenes, frames=ns.frames,
                              epochs1=ns.epochs1, epochs2=ns.epochs2,
                              occlusion=ns.occlusion,
                              init_weights=ns.init_weights))

    def dump():
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)

    print(report["card"], flush=True)
    if ns.occlusion:
        fs.apply_occlusion_recipe()
    fs.TRAIN_SCENES = fs.TRAIN_SCENES[:ns.scenes]
    if ns.eval_frames_per_lap:
        fs.DEFAULT_EVAL["frames_per_lap"] = ns.eval_frames_per_lap
        fs.EVAL_WORLD["frames_per_lap"] = ns.eval_frames_per_lap
    work_out = os.path.join(ns.work, "train")
    eval_root = os.path.join(ns.work, "worlds", "eval")
    root = os.path.join(ns.work, "worlds", "train")
    t0 = time.time()
    fs.build_training_worlds(root, frames=ns.frames)
    report["worlds_s"] = time.time() - t0
    weights = os.path.join(work_out, "weights_final.msgpack")
    targs = tfs.build_parser().parse_args([
        "--root", root, "--out", work_out, "--weights_out", weights,
        "--epochs1", str(ns.epochs1), "--epochs2", str(ns.epochs2),
        "--init_weights", ns.init_weights, "--device", ns.device])
    report["train"] = tfs.train(targs)
    for name in ("weights_final.msgpack", "render_meta.json"):
        shutil.copy(os.path.join(work_out, name), ns.out)
    steps = os.path.join(work_out, "steps.jsonl")
    with open(steps, "rb") as f, gzip.open(
            os.path.join(ns.out, "steps.jsonl.gz"), "wb") as g:
        shutil.copyfileobj(f, g)
    report["epochs"] = epoch_table(steps, fs.full_train_args(
        root, work_out, ns.epochs1, ns.epochs2))
    s1 = [e for e in report["epochs"] if e["stage"] == 1]
    report["stage1_last_below_first"] = (s1[-1]["mean"]["loss"]
                                         < s1[0]["mean"]["loss"])
    dump()

    report["eval"] = {}
    runs = [("trained", weights)]
    if ns.reference:
        runs.append(("reference", ns.reference))
    runs += [tuple(x.split("=", 1)) for x in ns.also]
    solvers = [("", None)]
    if ns.trimmed:
        solvers.append(("_trimmed", {"robust_register": False}))
    for suffix, overrides in solvers:
        for name, w in runs:
            report["eval"][name + suffix] = dict(
                weights=os.path.relpath(w, REPO), tpu_overrides=overrides,
                **fs.evaluate(w, os.path.join(ns.work, "eval",
                                              name + suffix),
                              eval_root, tpu_overrides=overrides,
                              device=ns.device))
            dump()

    # the reference's .pth schema, beside the msgpack (render_meta.json)
    args = config_from_yaml(os.path.join(REPO, "configs/infer/sample.yaml"))
    pth = os.path.splitext(weights)[0] + ".pth"
    from_msgpack = load_weights(args, weights)
    save_torch_weight(pth, *from_msgpack, args)
    exported = dict(pth_bytes=os.path.getsize(pth),
                    state_dicts_equal=same_state(load_weights(args, pth),
                                                 from_msgpack))
    res = fs.evaluate(pth, os.path.join(ns.work, "eval", "trained_pth"),
                      eval_root, device=ns.device)
    exported["eval"] = res
    exported["files_identical"] = {
        run: {f: filecmp.cmp(os.path.join(res["runs"][run]["out_dir"], f),
                             os.path.join(report["eval"]["trained"]["runs"]
                                          [run]["out_dir"], f),
                             shallow=False) for f in TRAJECTORY_FILES}
        for run in res["runs"]}
    exported["identical"] = all(all(v.values()) for v in
                                exported["files_identical"].values())
    report["export"] = exported
    if ns.reference:
        off = {k: report["eval"][k]["runs"]["loops_off"]["ate_aligned_m"]
               for k in ("trained", "reference")}
        report["ate_no_loop_ratio_trained_over_reference"] = (
            off["trained"] / off["reference"])
    dump()
    print(json.dumps({k: v for k, v in report.items() if k != "epochs"}),
          flush=True)
    return report


if __name__ == "__main__":
    main()
