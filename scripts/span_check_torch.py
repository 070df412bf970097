"""Measures the port's spans (deeppointmap_tpu_torch/utils/timer.py) on the
card, on the benchmark's own cells (BENCHMARK.json, benchmark/):

- `cost`: host microseconds a span costs outside a scope and inside one
  with no profiler recording, and inside one under the benchmark's
  spans-only profiler (benchmark/lib/trace.profiler), beside a bare
  `perf_counter` pair and an ungated `record_function`;
- `sync`: every synchronising call the host makes (under
  `torch.cuda.set_sync_debug_mode("warn")`) over one whole `slam_loop2`
  session and `--steps` `train_reg_b4` steps, by the innermost span open
  on its thread ("outside" where none is, with the program line that
  made it), a frame and a step;
- `cover`: a traced window of each cell through the benchmark's drivers:
  the per-layer metrics, and the share of the window frames' wall time
  (`frame_s`) that `slam.odometry` + `mapping` + `loop_closure` +
  `extract` cover, and of the steps' `batch_s` that `train.read` +
  `train.transform` + `train.assemble` cover.

    python3 scripts/span_check_torch.py [--out DIR] \\
        [--phases cost,sync,cover] [--seed N] [--steps 5] [--seconds 12]

Writes <out>/span_check.json and prints it as the last line of standard
output. Needs a card; `--device cpu --root R --bench B` rehearses it on
the CPU on a small copy of the benchmark (benchmark/tests/tiny.py).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import threading
import time
import traceback
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.lib import scans, spec  # noqa: E402
from benchmark.lib import spans as bspans  # noqa: E402
from benchmark.lib import trace as btrace  # noqa: E402
from deeppointmap_tpu_torch.utils import timer  # noqa: E402

SLAM_STAGES = ("slam.odometry", "mapping", "loop_closure", "extract")
#: the spans meant to hold every host sync
SYNC_SPANS = ("engine.wait", "kabsch.solve", "train.sync")
BATCH_SPANS = ("train.read", "train.transform", "train.assemble")


def _per_call_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n * 1e6


def cost(n: int = 200000, n_prof: int = 20000, repeats: int = 5) -> dict:
    """Host us a call, best of `repeats`, with the bare loop's own cost
    (`loop_us`) left in."""
    clock = time.perf_counter

    def loop(k):
        for _ in range(k):
            pass

    def pair(k):
        for _ in range(k):
            clock()
            clock()

    site = timer.span("cost")     # as the program's modules keep them

    def outside(k):
        for _ in range(k):
            with site:
                pass

    def inside(k):
        with timer.scope("cost.scope"):
            for _ in range(k):
                with site:
                    pass

    def made_inside(k):
        with timer.scope("cost.scope"):
            for _ in range(k):
                with timer.span("cost"):
                    pass

    def ungated(k):
        for _ in range(k):
            with torch.profiler.record_function("cost.ungated"):
                pass

    best = lambda fn, k: min(_per_call_us(fn, k) for _ in range(repeats))
    out = dict(loop_us=best(loop, n), perf_counter_pair_us=best(pair, n),
               span_outside_scope_us=best(outside, n),
               span_in_scope_us=best(inside, n),
               span_made_in_scope_us=best(made_inside, n),
               record_function_ungated_us=best(ungated, n_prof))
    prof = btrace.profiler()
    with prof:
        with btrace.span("window", True):
            out["span_in_scope_profiled_us"] = _per_call_us(inside, n_prof)
    s = btrace.summarize(prof)
    out.update(profiled_spans_only=s["spans_only"],
               profiled_host_events=s["host_events"], iterations=n,
               iterations_profiled=n_prof)
    return out


@contextlib.contextmanager
def sync_attribution(cuda: bool = True):
    """Counts synchronising calls by (thread, innermost open span) while
    set_sync_debug_mode("warn") reports each as a warning in the thread
    that made it; spans are followed by wrapping span's enter and exit
    for the duration. Yields (counts, where) with `where` the program
    line of each call outside the SYNC_SPANS, under its innermost span.
    Without `cuda` (a rehearsal on the CPU) nothing reports a sync."""
    counts, where = collections.Counter(), collections.Counter()
    local = threading.local()
    enter, exit_ = timer.span.__enter__, timer.span.__exit__

    def enter_(self):
        local.__dict__.setdefault("open", []).append(self.name)
        return enter(self)

    def exit_open(self, *exc):
        local.open.pop()
        return exit_(self, *exc)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        opened = local.__dict__.get("open") or []
        label = opened[-1] if opened else "outside"
        thread = threading.current_thread().name
        counts[f"{thread}:{label}"] += 1
        if label not in SYNC_SPANS:
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "deeppointmap_tpu_torch" in f.filename
                      or "benchmark" in f.filename]
            if frames:
                f = frames[-1]
                where[f"{label}: {os.path.relpath(f.filename, REPO)}:"
                      f"{f.lineno} {f.name}"] += 1

    timer.span.__enter__, timer.span.__exit__ = enter_, exit_open
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield counts, where
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
    finally:
        timer.span.__enter__, timer.span.__exit__ = enter, exit_


def sync_slam(cell, seed: int, device, say) -> dict:
    """One whole session of the cell's drive after its warm session."""
    from benchmark.drivers import slam as dslam
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.pipeline.infer import (
        device_preprocess_config)
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    cfg, traf = cell.config, cell.traffic
    out_dir = os.path.join(scans.CACHE, "span_check_slam")
    args = dslam.build_args(cfg, out_dir)
    root = dslam.drive(seed, traf)
    engine = InferenceEngine(args, *load_weights(
        args, os.path.join(REPO, cfg["weights"])), device=device,
        preprocess_cfg=device_preprocess_config(args))
    runner = dslam.Runner(args, engine, root, out_dir, traced=False)
    runner.session(float("inf"), max_frames=int(traf["warm_frames"]))
    runner.sessions.clear()
    with sync_attribution(device.type == "cuda") as (counts, where):
        runner.session(float("inf"))
    frames = runner.sessions[-1]["fed"]
    say(f"sync slam: {frames} frames, {dict(counts)}")
    return dict(frames=frames, syncs=dict(counts), outside_at=dict(where),
                per_frame={k: v / frames for k, v in counts.items()})


def sync_train(cell, seed: int, steps: int, device, say) -> dict:
    """`steps` steps of the cell's Trainer after two warm ones."""
    from benchmark.drivers import train as dtrain
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.pipeline.train import training_transforms
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    sys.modules.setdefault("torch.utils.tensorboard", None)
    root, names = dtrain.training_scenes(cell.traffic)
    out_dir = os.path.join(scans.CACHE, "span_check_train")
    args = dtrain.build_args(cell.config, root, names, out_dir)
    enc_sd, dec_sd = dtrain.draw_state(args, seed, device)
    rng = np.random.default_rng([int(seed) % (1 << 63), 5])
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    trainer = Trainer(args, ds, enc_sd, dec_sd, rng=rng, device=device)
    orig = trainer.train_step
    left = [2]

    class Stop(Exception):
        pass

    def train_step(batch):
        if left[0] <= 0:
            raise Stop
        left[0] -= 1
        return orig(batch)

    trainer.train_step = train_step

    def run():
        while True:
            try:
                trainer.train_one_epoch()
            except Stop:
                return

    run()
    left[0] = steps
    with sync_attribution(device.type == "cuda") as (counts, where):
        run()
    trainer.close()
    say(f"sync train: {steps} steps, {dict(counts)}")
    return dict(steps=steps, syncs=dict(counts), outside_at=dict(where),
                per_step={k: v / steps for k, v in counts.items()})


def cover(cell, seed: int, seconds: float, device, say) -> dict:
    """A traced window through the cell's driver (the check after it
    included): per-layer metrics and the spans' coverage."""
    out = spec.driver(cell.traffic).run(cell, seed, seconds, True, device,
                                        say=say)
    rec = out["rec"]
    res = dict(metrics=spec.read_per_layer(cell.per_layer, rec),
               busy_s=out["trace"]["busy_s"],
               window_s=out["trace"]["window_s"],
               launches=out["trace"]["launches"])
    if rec["driver"] == "slam":
        covered = sum(rec["stage_s"].get(n, 0.0) for n in SLAM_STAGES)
        res.update(frames=rec["frames"], frame_s=sum(rec["frame_s"]),
                   stage_s=rec["stage_s"],
                   coverage=covered / max(sum(rec["frame_s"]), 1e-12))
    else:
        rows = bspans.window_rows(rec) or []
        covered = sum(r["spans"].get(n, 0.0) for r in rows
                      for n in BATCH_SPANS if "spans" in r)
        res.update(steps=len(rows), batch_s=sum(rec["batch_s"]),
                   spans={n: sum(r.get("spans", {}).get(n, 0.0)
                                 for r in rows)
                          for n in (*BATCH_SPANS, "train.sync")},
                   coverage=covered / max(sum(rec["batch_s"]), 1e-12))
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="build/span_check")
    p.add_argument("--phases", default="cost,sync,cover")
    p.add_argument("--seed", type=int, default=7100000003)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=REPO, help="BENCHMARK.json's folder")
    p.add_argument("--bench", default=spec.BENCH,
                   help="the benchmark's folder")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measures the card "
                         "(--device cpu rehearses it)")
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    say = lambda m: print(m, file=sys.stderr, flush=True)
    phases = a.phases.split(",")
    res = dict(device=torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu",
               torch=torch.__version__)
    slam = spec.cell("slam_loop2", a.root, a.bench)
    train = spec.cell("train_reg_b4", a.root, a.bench)
    if "cost" in phases:
        res["cost"] = cost()
        say(f"cost: {res['cost']}")
    if "sync" in phases:
        res["sync_slam"] = sync_slam(slam, a.seed, device, say)
        res["sync_train"] = sync_train(train, a.seed, a.steps, device, say)
    if "cover" in phases:
        for name, cell in (("cover_slam", slam), ("cover_train", train)):
            res[name] = cover(cell, a.seed, a.seconds, device, say)
            say(f"{name}: {res[name]}")
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "span_check.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
