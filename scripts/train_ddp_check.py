#!/usr/bin/env python3
"""Data-parallel training of the port on several GPUs (parallel/ddp.py over
NCCL) against one process on one GPU, at DeepPointMap-B full width.

    python3 scripts/train_ddp_check.py [--world 4] [--time_steps 6] \
        [--out chiprun_out]

Renders chip_smoke.py's training scene (24 frames), writes its full-width
training config with SGD in both stages, `world` items a global step in
stage 1 and 4 pairs in stage 2, and the trained weights of
artifacts/full_size_occ_v2 as the start. Then `world` ranks of
tests/test_torch_ddp_worker.py, one GPU each, take one step of each stage on
their slices of the first global batch and `--time_steps` timed stage-1
steps; one process on GPU 0 does the same on the whole batch. Prints the
card's nvidia-smi line and one JSON line: each stage's loss (ranks against
one process, rtol 1e-5), the update error (||d|| / ||update|| over all
parameters <= 1e-3 and for each tensor <= 5e-2, the full-width tolerances
of tests/test_torch_train_full_width.py), the ranks' parameters equal bit
for bit, and the seconds a stage-1 step takes with `world` ranks against
one GPU on the same global batch. Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORKER = os.path.join(REPO, "tests", "test_torch_ddp_worker.py")
FRAMES = 24
#: seconds a rank may run before its watchdog dumps its stacks and exits
RANK_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prepare(work: str, world: int) -> None:
    """The scene, cfg.json and params.pt the workers read."""
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights

    root = os.path.join(work, "world")
    frames = cs.TRAIN_SCENE["frames"]
    cs.TRAIN_SCENE["frames"] = FRAMES
    try:
        cs.render_train_scene(syn, root)
    finally:
        cs.TRAIN_SCENE["frames"] = frames
    cfg = cs.train_config(root, os.path.join(work, "log"))
    sgd = dict(type="sgd", kwargs=dict(lr=1e-3))
    cfg["train"]["registration"].update(batch_size=world, optimizer=sgd)
    cfg["train"]["loop_detection"].update(batch_size=4, optimizer=sgd)
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    torch.save(load_msgpack_weights(os.path.join(REPO, cs.WEIGHTS)),
               os.path.join(work, "params.pt"))


def run_ranks(work: str, world: int, time_steps: int) -> None:
    """The ranks, each with a watchdog that dumps its stacks and exits
    after RANK_S; raises with every rank's output tail if one fails."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--rank", str(r), "--world", str(world),
         "--port", str(port), "--work", work, "--device", "cuda",
         "--time_steps", str(time_steps), "--watchdog_s", str(RANK_S)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_S + 60)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{o[-2500:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"ranks failed:\n{tails}")


def update_error(got: dict, want: dict, start: dict) -> tuple:
    """(||d|| / ||update|| over all parameters, worst tensor and its)."""
    diff2 = upd2 = 0.0
    worst = (0.0, "")
    for k, w in want.items():
        upd = (w - start[k]).double()
        d = (got[k] - w).double()
        diff2 += float(d.norm()) ** 2
        upd2 += float(upd.norm()) ** 2
        if float(upd.norm()) > 0:
            worst = max(worst, (float(d.norm() / upd.norm()), k))
    return (diff2 / max(upd2, 1e-300)) ** 0.5, worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--time_steps", type=int, default=6)
    ap.add_argument("--out", default="")
    ns = ap.parse_args()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < ns.world:
        print(f"train_ddp_check: needs {ns.world} CUDA devices",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_ddp_worker as worker

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    with tempfile.TemporaryDirectory() as work:
        prepare(work, ns.world)
        run_ranks(work, ns.world, ns.time_steps)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=True) for r in range(ns.world)]
        one = worker.step_stages(worker.build(work, 0, "cuda:0"),
                                 ns.time_steps)
        start = {f"{part}.{k}": v for part, sd in zip(
            ("encoder", "decoder"), torch.load(os.path.join(
                work, "params.pt"), weights_only=True)) for k, v in sd.items()}
    out = dict(world=ns.world, card=smi[0], frames=FRAMES, stages={})
    ok = True
    for stage in (1, 2):
        metrics, _, params = ranks[0][stage]
        want_m, _, want_p = one[stage]
        same = all(torch.equal(params[k], r[stage][2][k])
                   for r in ranks[1:] for k in params)
        total, worst = update_error(params, want_p, start)
        relerr = abs(metrics["loss"] - want_m["loss"]) / abs(want_m["loss"])
        out["stages"][stage] = dict(
            loss_ranks=metrics["loss"], loss_one=want_m["loss"],
            loss_relerr=relerr, update_error=total,
            worst_tensor=worst[1], worst_tensor_error=worst[0],
            ranks_equal=same, valid_points_by_rank=[r[stage][1]
                                                    for r in ranks])
        ok &= relerr <= 1e-5 and total <= 1e-3 and worst[0] <= 5e-2 and same
    med = lambda xs: float(np.median(xs[1:] or xs))
    out["stage1_step_s"] = dict(
        ranks=[med(r["step_s"]) for r in ranks], one_gpu=med(one["step_s"]),
        items_per_step=ns.world)
    out["ok"] = bool(ok)
    line = json.dumps(out)
    print(smi[0])
    print(line)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, "train_ddp_check.json"), "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
