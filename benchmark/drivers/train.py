"""The general training loop: stage-1 (registration) steps of the port's
`Trainer`, back to back through `Trainer.train_one_epoch`, with the batch
built on the host inside the loop as users run it.

The traffic file gives the scenes (`world`, `render`, one trajectory a
scene, rendered once from `render_seed`), the number of set-up steps the
reference follows (`checked_steps`) and the traced window's length; the configuration file
gives the model, loss, training and transform trees. The run's seed draws
the weights (on the card, one generator, a few large draws), the
trainer's generator (batch order, map sizes) and nothing else.

Set-up builds the one Trainer that the window uses and drives it through
its first `checked_steps` steps by the window's own call
(`train_one_epoch`); those steps' batches, the first gradient (from
AdamW's first moment after one step) and the parameters after the last of
them are kept for the check. The window then runs epochs of the same
Trainer until its time is up; a step is counted when it ends inside the
window.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from benchmark.checks import train as checks
from benchmark.counts import roofline as rl
from benchmark.lib import scans
from benchmark.lib import trace as tr


class _Closed(Exception):
    """The window's time is up: ends `train_one_epoch` between steps."""


def build_args(config: dict, root: str, scene_names, out_dir: str):
    from deeppointmap_tpu_torch.config import config_from_dict

    tree = json.loads(json.dumps(config["model"]))
    tree.update(dataset=[dict(name="bench_train", root=root,
                              scenes=list(scene_names),
                              reader=dict(type="npz"))],
                infer_tgt=out_dir, weight="", checkpoint="",
                multi_thread=False, num_workers=2, profile=False)
    return config_from_dict(tree)


def training_scenes(traf: dict) -> tuple:
    """-> (dataset root, scene names): each scene of the traffic rendered
    once (cached), linked as `<root>/scene<i>/0`."""
    fixed = int(traf["render_seed"])
    root = os.path.join(scans.CACHE, "train_scenes", scans.drive_dir(
        fixed, traf["world"], traf["render"], traf["scenes"]
    ).rsplit(os.sep, 1)[-1])
    names = []
    for i, sc in enumerate(traf["scenes"]):
        world = dict(traf["world"], seed=int(sc["world_seed"]))
        traj = dict(radius=sc["radius"], direction=sc.get("direction", 1),
                    frames_per_lap=sc["frames"], laps=1)
        drive = scans.ensure_drive(fixed, world, traf["render"], traj,
                                   workers=int(traf.get("render_workers", 8)))
        agent = os.path.join(root, f"scene{i}", "0")
        if not os.path.exists(agent):
            os.makedirs(os.path.dirname(agent), exist_ok=True)
            os.symlink(drive, agent)
        names.append(f"scene{i}")
    return root, names


def draw_state(args, seed: int, device):
    """The models' initial parameters from the seed, on `device`: one
    normal draw (std 0.02) for every matrix, zero biases, unit norm
    scales, in the port's parameter names and shapes. -> (encoder state
    dict, decoder state dict)."""
    from deeppointmap_tpu_torch.models.decoder import Decoder
    from deeppointmap_tpu_torch.models.encoder import Encoder

    shapes = {}
    for part, cls in (("encoder", Encoder), ("decoder", Decoder)):
        for name, t in cls.from_config(args).state_dict().items():
            shapes[(part, name)] = tuple(t.shape)
    mats = [k for k in sorted(shapes) if len(shapes[k]) >= 2]
    total = sum(int(np.prod(shapes[k])) for k in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device) * 0.02
    out = {"encoder": {}, "decoder": {}}
    off = 0
    for k in sorted(shapes):
        shape = shapes[k]
        if len(shape) >= 2:
            n = int(np.prod(shape))
            out[k[0]][k[1]] = flat[off:off + n].view(shape)
            off += n
        elif k[1].endswith("bias"):
            out[k[0]][k[1]] = torch.zeros(shape, device=device)
        else:
            out[k[0]][k[1]] = torch.ones(shape, device=device)
    return out["encoder"], out["decoder"]


def run(cell, seed: int, seconds: float, trace: bool, device, controls=(),
        say=print) -> dict:
    out = measure(cell, seed, seconds, trace, device, say)
    return finish(out, device, controls, say)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            say=print) -> dict:
    """Set-up, the checked steps and the window; the program's state
    stays in the result (`state`) for `finish`."""
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.pipeline.train import training_transforms
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    cfg, traf = cell.config, cell.traffic
    # the Trainer writes TensorBoard scalars where TensorBoard imports;
    # where installed it loads TensorFlow, and with it JAX: it stays out
    sys.modules.setdefault("torch.utils.tensorboard", None)
    marks = [("start", time.perf_counter())]
    root, names = training_scenes(traf)
    marks.append(("render", time.perf_counter()))
    out_dir = os.path.join(scans.CACHE, "train_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = build_args(cfg, root, names, out_dir)
    enc_sd, dec_sd = draw_state(args, seed, device)
    p0 = {("encoder", k): v.clone() for k, v in enc_sd.items()}
    p0.update({("decoder", k): v.clone() for k, v in dec_sd.items()})
    rng = np.random.default_rng([int(seed) % (1 << 63), 5])
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    trainer = Trainer(args, ds, enc_sd, dec_sd, rng=rng, device=device)
    del enc_sd, dec_sd
    marks.append(("trainer", time.perf_counter()))

    rec = dict(batches=[], g1=None, p3=None, losses=[], done=[], valid=[],
               shapes=[], total_steps=trainer._steps_per_epoch() * int(
                   args.train.registration.num_epochs))
    n_check = int(traf.get("checked_steps", 3))
    state = dict(deadline=float("inf"), limit=n_check, steps=0,
                 capture=True)
    orig = trainer.train_step
    names_of = {}
    for part, model in (("encoder", trainer.encoder),
                        ("decoder", trainer.decoder)):
        for name, p in model.named_parameters():
            names_of[p] = (part, name)

    def train_step(batch):
        if state["steps"] >= state["limit"] \
                or time.perf_counter() >= state["deadline"]:
            raise _Closed
        if state["capture"]:
            rec["batches"].append(batch)
        with tr.span("step", trace and not state["capture"]):
            out = orig(batch)
        state["steps"] += 1
        if state["capture"]:
            if state["steps"] == 1:
                b1 = trainer.optimizer.defaults["betas"][0]
                st = trainer.optimizer.state
                rec["g1"] = {names_of[p]: (st[p]["exp_avg"] / (1 - b1))
                             .clone() if "exp_avg" in st.get(p, {})
                             else torch.zeros_like(p)
                             for g in trainer.optimizer.param_groups
                             for p in g["params"]}
            if state["steps"] == n_check:
                rec["p3"] = {names_of[p]: p.detach().clone()
                             for p in names_of}
            rec["losses"].append(out["loss"])
        else:
            rec["done"].append(time.perf_counter())
            rec["valid"].append(np.asarray(batch.valid).reshape(
                -1, np.asarray(batch.valid).shape[-1]).sum(-1))
            rec["shapes"].append(tuple(np.asarray(batch.points).shape[:2]))
        return out

    trainer.train_step = train_step
    if trace:   # a span around each batch the Trainer builds
        iter_batches = trainer._iter_batches

        def spanned_batches():
            it = iter_batches()
            while True:
                with tr.span("batch", not state["capture"]):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch
        trainer._iter_batches = spanned_batches
    while state["steps"] < n_check:
        try:
            trainer.train_one_epoch()
        except _Closed:
            pass
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("checked_steps", time.perf_counter()))
    say("setup: " + ", ".join(f"{n} {t - p:.3f} s" for (_, p), (n, t)
                              in zip(marks, marks[1:])))

    state.update(capture=False, limit=1 << 60, steps=0)
    window = min(seconds, float(traf.get("trace_seconds", seconds))) \
        if trace else seconds
    prof = tr.profiler() if trace else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    state["deadline"] = deadline = t0 + window
    with tr.span("window", trace):
        while time.perf_counter() < deadline:
            try:
                trainer.train_one_epoch()
            except _Closed:
                break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if prof is not None:
        prof.__exit__(None, None, None)
    trainer.train_step = orig
    trainer.close()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    done = [t for t in rec["done"] if t <= deadline]
    n_steps = len(done)
    frames = sum(int(np.prod(s)) for s in rec["shapes"][:n_steps])
    say(f"window: {n_steps} steps, {frames} frames in {window:.3f} s "
        f"(batches of (groups, frames) {sorted(set(rec['shapes']))}); "
        f"first losses {rec['losses']}")
    out = dict(window_start=t0, attempted=n_steps, failed=0,
               memory_peak=peak,
               e2e={"train_frames_per_s": frames / window})
    steps_file = os.path.join(out_dir, "steps.jsonl")
    rows = []
    if os.path.exists(steps_file):
        with open(steps_file) as f:
            rows = [json.loads(line) for line in f]
    win_rows = rows[n_check:n_check + n_steps]
    if trace:
        summary = tr.summarize(prof)
        out["trace"] = summary
        say(f"trace: spans only {summary['spans_only']}, "
            f"{summary['host_events']} host events, {summary['launches']} "
            f"launches, {n_steps} steps")
        peaks = rl.KNOWN_CARDS.get(torch.cuda.get_device_name(device)) \
            if device.type == "cuda" else None
        out["rec"] = dict(
            driver="train", steps=n_steps, window_s=window, trace=summary,
            batch_s=[r["batch_s"] for r in win_rows],
            counts=_counts(args, rec, n_steps, peaks or rl.H100_SXM),
            peaks_known=peaks is not None)
    del prof
    out["state"] = (trainer, rec, p0, args)
    return out


def _counts(args, rec, n_steps, peaks):
    """train_mfu's and K1's roofline's work over the window's steps, from
    each step's batch shape and valid points."""
    tree = rl.Tree(json.loads(json.dumps(args)))
    n = int(args.tpu.encoder_points)
    max_pairs = int(args.train.registration.get("max_pairs", 1024))
    total, fps = rl.Cost(), rl.Cost()
    for (b, s), valid in zip(rec["shapes"][:n_steps],
                             rec["valid"][:n_steps]):
        parts = rl.train_step_cost(tree, b, s, n, [int(v) for v in valid],
                                   max_pairs, rl.BF16)
        total = total + rl.total(parts)
        fps = fps + rl.encoder_neighbours(tree.encoder, n,
                                          [int(v) for v in valid])["fps"]
    return dict(ops_s=total.seconds(peaks)[0], fps_bound_s=fps.bound(peaks))


def finish(out: dict, device, controls, say=print) -> dict:
    """The check, after the window: the program's state is freed first."""
    trainer, rec, p0, args = out.pop("state")
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    nums, ctl, info = checks.compare(rec, p0, args, device, controls)
    say(f"checked {len(rec['batches'])} steps in "
        f"{time.perf_counter() - t:.3f} s: {info}")
    out["numbers"], out["controls"] = nums, ctl
    return out
