#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: odometry throughput of the whole
pipelined SLAM system on one card, with accuracy and scale blocks (the
port's counterpart of bench.py, block for block).

    python3 bench_torch.py [--blocks throughput,accuracy,scale]
                           [--mode mt|engine] [--device cuda|cpu]

Prints ONE JSON line, last, with bench.py's keys:
  {"metric": "scans_per_sec_odometry", "value": N, "unit": "scans/s",
   "trials": [...5 trials...], "keyframes": [...each trial's...],
   "frames": F, "mode": "mt",
   "accuracy": {"ate_m", "ate_no_loop_m", "loop_edges", "model",
                "demo": {...}},
   "scale": {...}, "device": "<nvidia-smi name, power limit>"}
and "error" when a block failed; the process then exits 1. Nothing is
retried and no block takes another's place. Chatter goes to stderr; one
stdout line before the JSON names the matrix-product policy every block
runs under (`tpu.bf16` of the shipped configs on the device,
deeppointmap_tpu_torch/utils/precision.py: "bfloat16" on a card).

Blocks:
  throughput  bench.py `_measure`, mode mt: DeepPointMap-B at full width
      (configs/infer/sample.yaml over the `tpu:` defaults) with the trained
      artifacts/full_size_occ_v2 weights, streaming the 120 frames of
      chip_smoke.py's slam_a stream (data/synthetic.render_stream, written as
      KITTI .bin files, read back through pipeline.infer's host transform).
      Warm-up as bench.py's: one extract, one fused odometry step, a warm
      SlamSystem over 3 frames. Then 5 trials, each a fresh SlamSystem:
      MT_Init, MT_Step over every frame once, MT_Done, MT_Wait; `value` is
      the median trial's frames / seconds. bench.py streamed the KITTI
      sample with random weights (init_params(seed=0)); with random weights
      the synthetic stream's keyframe and drop decisions would be arbitrary,
      so the port streams the trained artifact. Under sample.yaml's drop
      gates (rmse 0.5, confidence 0.6) that artifact's registrations on
      this stream read rmse 2-6, so the rmse gate drops nearly every frame
      (5 keyframes in 120 frames on the card), and the JAX package drops
      the same frames (tests/test_torch_bench_stream.py). So `value` is
      the rate of the drop path, not that of a stream that registers, and
      is no cell's traffic as it stands. bench.py's `vs_baseline`
      (0.322 scans/s, measured on the KITTI sample) is dropped: the ratio
      would compare different scans. `--mode engine` times bench.py's
      engine-level loop instead (30 double-buffered fused odometry steps on
      two frames), only when asked for.
  accuracy  bench.py `_accuracy`: the two-lap world of
      pipeline/full_size.build_eval_world under the artifact's
      render_meta.json, full_eval_args, full_size_occ_v2, loops on and off
      (aligned ATE); then `demo`: demo_args with trust range 15 on the
      two-lap 48-frames-a-lap world (2000 points a scan) with
      artifacts/synthetic_demo.
  scale  bench.py `_scale`: pipeline/scale.run_scale(300, 100) with the demo
      weights; the host RSS growth and, beside it, the card's allocated
      memory growth over the run.

BENCH_BUDGET_SEC (default 4500) bounds the whole run: a block that would
start after it is reported as an error. Outputs (worlds, trajectories) go
under log_infer/bench/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BENCH_BUDGET_SEC = int(os.environ.get("BENCH_BUDGET_SEC", "4500"))
FULL_WEIGHTS = os.path.join(
    REPO, "artifacts/full_size_occ_v2/weights_final.msgpack")
DEMO_WEIGHTS = os.path.join(
    REPO, "artifacts/synthetic_demo/weights_final.msgpack")
SAMPLE_YAML = os.path.join(REPO, "configs/infer/sample.yaml")
#: chip_smoke.py's slam_a frames
THROUGHPUT_FRAMES = 120
TRIALS = 5
ENGINE_ITERS = 30
BLOCKS = ("throughput", "accuracy", "scale")


def matmul_policy(device: str) -> str:
    """The tpu.bf16 rule's policy for sample.yaml's models on `device`
    (every block's config sets `tpu.bf16: true`)."""
    from deeppointmap_tpu_torch.config import config_from_yaml
    from deeppointmap_tpu_torch.utils.precision import apply_matmul_precision

    return apply_matmul_precision(config_from_yaml(SAMPLE_YAML).tpu, device)


def card(device: str) -> str:
    """The card as nvidia-smi names it, with its power limit; "cpu" for the
    CPU."""
    if not str(device).startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _prepare(device: str, work: str, frames: int):
    """sample.yaml's engine with the trained weights, the stream's frames
    through the host transform, and bench.py's warm-up. -> (args, engine,
    frames, candidate): the candidate is frame 0 as the warm-up extracted
    it (descriptors, their validity, points, point validity)."""
    from deeppointmap_tpu_torch.config import config_from_yaml
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.data.dataset import BasicAgent
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.pipeline.infer import (
        device_preprocess_config, make_infer_transform)
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine
    from deeppointmap_tpu_torch.slam.system import SlamSystem

    args = config_from_yaml(SAMPLE_YAML, device=device)
    seq = syn.write_bins(syn.render_stream(frames)[0],
                         os.path.join(work, "stream"))
    agent = BasicAgent(root=seq, reader="auto")
    agent.set_independent(make_infer_transform(args))
    items = [agent[i] for i in range(len(agent))]
    enc_sd, dec_sd = load_weights(args, FULL_WEIGHTS)
    engine = InferenceEngine(args, enc_sd, dec_sd, device=device,
                             preprocess_cfg=device_preprocess_config(args))
    scans = [(f[0][0], f[3][0]) for f in items]
    d0, dv0, pv0 = engine.extract(scans[0][0][None], scans[0][1][None])
    cand = (d0[0], dv0[0], scans[0][0], pv0[0])
    engine.odometry_step(scans[1][0][None], scans[1][1][None], *cand,
                         num_sample=0.5)
    out = os.path.join(work, "throughput")
    os.makedirs(out, exist_ok=True)
    warm = SlamSystem(args, engine, system_id=1, logger_dir=out)
    warm.warmup(items[0])
    for f in items[:3]:
        warm.step(f)
    return args, engine, items, cand


def _mt_trials(args, engine, items, work: str, trials: int) -> tuple:
    """Scans/s and keyframes of each trial: a fresh pipelined SlamSystem
    over every frame once (sample.yaml's drop gates decide how many frames
    take the keyframe path, so the count goes beside the rate)."""
    from deeppointmap_tpu_torch.slam.system import SlamSystem

    out = os.path.join(work, "throughput")
    rates, keyframes = [], []
    for trial in range(trials):
        system = SlamSystem(args, engine, system_id=2 + trial,
                            logger_dir=out)
        system.MT_Init()
        t0 = time.perf_counter()
        for f in items:
            system.MT_Step(f)
        system.MT_Done()
        system.MT_Wait()
        rates.append(len(items) / (time.perf_counter() - t0))
        keyframes.append(int(system.posegraph_map.key_frame_num))
        print(f"trial {trial}: {rates[-1]:.3f} scans/s, {keyframes[-1]} "
              f"keyframes", file=sys.stderr, flush=True)
    return rates, keyframes


def _engine_loop(engine, items, cand, iters: int = ENGINE_ITERS) -> float:
    """bench.py's engine mode: the fused odometry step, double-buffered as
    the pipelined odometer runs it (frame i+1 launched before frame i is
    fetched), on the first two frames against the warm-up's candidate.
    -> scans/s."""
    scans = [(f[0][0], f[3][0]) for f in items[:2]]
    t0 = time.perf_counter()
    prev = None
    for i in range(iters):
        buf, v = scans[i % 2]
        cur = engine.odometry_step_async(buf[None], v[None], *cand,
                                         num_sample=0.5)
        if prev is not None:
            prev()
        prev = cur
    prev()
    return iters / (time.perf_counter() - t0)


def throughput(device: str, work: str, mode: str = "mt",
               frames: int = THROUGHPUT_FRAMES, trials: int = TRIALS,
               engine_iters: int = ENGINE_ITERS) -> dict:
    """-> {"value", "trials", "keyframes", "frames", "mode"}: the median
    trial's scans/s (mt), or the engine loop's (engine)."""
    args, engine, items, cand = _prepare(device, work, frames)
    if mode == "mt":
        rates, keyframes = _mt_trials(args, engine, items, work, trials)
        return dict(value=round(float(np.median(rates)), 3),
                    trials=[round(r, 3) for r in rates],
                    keyframes=keyframes, frames=len(items), mode=mode)
    if mode == "engine":
        rate = _engine_loop(engine, items, cand, engine_iters)
        return dict(value=round(rate, 3), trials=None, keyframes=None,
                    frames=2, mode=mode)
    raise ValueError(f"unknown mode {mode!r}")


def _two_lap(make_args, weights: str, root: str, out: str,
             device: str) -> dict:
    """Two-lap SLAM loops on and off: the second lap revisits the first
    beyond the trust zone, so loop closure must detect, verify and
    optimize. -> aligned ATE each way and the loop edges."""
    from deeppointmap_tpu_torch.pipeline.demo import run_slam

    blk = {}
    for name, loops in (("ate_m", True), ("ate_no_loop_m", False)):
        args = make_args()
        args.infer_src = [os.path.join(root, "scene0", "0")]
        args.slam_system.enable_loop_closure = loops
        args.slam_system.enable_global_optimization = loops
        res = run_slam(args, weights, os.path.join(out, name), device)
        blk[name] = round(res["ate_m"], 4)
        if loops:
            blk["loop_edges"] = res["loop_edges"]
    return blk


def accuracy(device: str, work: str, frames_per_lap: int | None = None,
             demo_frames_per_lap: int = 48) -> dict:
    """The full-size block (`frames_per_lap` None: the artifact's own lap)
    and the demo block under `demo`."""
    from deeppointmap_tpu_torch.data.synthetic import (circle_trajectory,
                                                       make_world,
                                                       write_npz_sequence)
    from deeppointmap_tpu_torch.pipeline import full_size
    from deeppointmap_tpu_torch.pipeline.demo import demo_args

    out = os.path.join(work, "accuracy")
    saved = {k: dict(getattr(full_size, k))
             for k in ("WORLD", "RENDER", "EVAL_WORLD")}
    try:
        full_size.apply_artifact_render(FULL_WEIGHTS)
        if frames_per_lap:
            full_size.EVAL_WORLD["frames_per_lap"] = frames_per_lap
        root = os.path.join(work, "full_world")
        full_size.build_eval_world(root)
        res = _two_lap(lambda: full_size.full_eval_args(root, out),
                       FULL_WEIGHTS, root, os.path.join(out, "full"), device)
    finally:
        for k, v in saved.items():
            getattr(full_size, k).clear()
            getattr(full_size, k).update(v)
    res["model"] = "full_size_B"

    droot = os.path.join(work, f"demo_world{demo_frames_per_lap}")
    if not os.path.isdir(os.path.join(droot, "scene0")):
        rng = np.random.default_rng(0)
        lap = circle_trajectory(demo_frames_per_lap, radius=25.0)
        write_npz_sequence(droot, make_world(rng), lap + lap, rng=rng,
                           max_points=2000)

    def demo_make():
        a = demo_args(droot, out)
        a.slam_system.loop_detection_trust_range = 15
        return a

    res["demo"] = _two_lap(demo_make, DEMO_WEIGHTS, droot,
                           os.path.join(out, "demo"), device)
    return res


def scale(device: str, work: str, frames: int = 300,
          block: int = 100) -> dict:
    """bench.py's scale keys, with the card's memory growth beside the
    RSS growth."""
    from deeppointmap_tpu_torch.pipeline.scale import run_scale

    s = run_scale(frames=frames, block=block,
                  root=os.path.join(work, f"scale_world{frames}"),
                  out=os.path.join(work, "scale"), device=device)
    return {
        "frames": s["frames"], "ate_m": s["ate_m"],
        "loop_edges": s["loop_edges"],
        "loop_floor_ok": s["loop_floor_ok"], "keyframes": s["keyframes"],
        "scans_per_sec_first_block": s["scans_per_sec_first_block"],
        "scans_per_sec_last_block": s["scans_per_sec_last_block"],
        "rss_growth_mb": s["rss_growth_mb"],
        "device_growth_mb": s["device_growth_mb"],
        "device_max_mb": s["device_max_mb"]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", default=",".join(BLOCKS),
                    help="comma-separated subset of " + ", ".join(BLOCKS))
    ap.add_argument("--mode", default="mt", choices=["mt", "engine"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "log_infer/bench"),
                    help="directory for worlds and trajectories")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    blocks = [b for b in ns.blocks.split(",") if b]
    unknown = sorted(set(blocks) - set(BLOCKS))
    if unknown:
        raise SystemExit(f"unknown blocks {unknown}; choose from {BLOCKS}")
    deadline = time.monotonic() + BENCH_BUDGET_SEC
    line = {"metric": "scans_per_sec_odometry", "value": 0.0,
            "unit": "scans/s", "trials": None}
    errors = {}
    try:
        from deeppointmap_tpu_torch.pipeline.common import require_device

        device = require_device(ns.device)
        line["device"] = card(device)
        print(f"matmul_policy: {matmul_policy(device)}", flush=True)
    except Exception as e:   # noqa: BLE001 -- reported in the line
        device, errors["device"] = None, f"{type(e).__name__}: {e}"
    run = {"throughput": lambda: throughput(device, ns.out, ns.mode),
           "accuracy": lambda: accuracy(device, ns.out),
           "scale": lambda: scale(device, ns.out)}
    for name in blocks if device is not None else []:
        if time.monotonic() > deadline:
            errors[name] = "budget exhausted"
            continue
        try:
            with contextlib.redirect_stdout(sys.stderr):
                res = run[name]()
        except Exception as e:   # noqa: BLE001 -- reported in the line
            traceback.print_exc()
            errors[name] = f"{type(e).__name__}: {e}"
            continue
        if name == "throughput":
            line.update(res)
        else:
            line[name] = res
    if errors:
        line["error"] = "; ".join(f"{k}: {v}" for k, v in errors.items())
    print(json.dumps(line), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
