"""The general SLAM loop: recorded drives through the port's SlamSystem,
as `deeppointmap_tpu_torch.pipeline.infer.run_sequence` drives them, call
for call (BasicAgent, the infer transform under `prefetch`, then
`SlamSystem.step`), each session a fresh SlamSystem over the whole drive,
sessions back to back.

The traffic file gives the drive (`world`, `render`, `trajectory`, the
`render_seed`), the frames of the warm session, the sample sizes of the
check, and the traced window's length; the configuration file gives the
model trees and the weights. A frame is done when its `step` returns; the
window counts the frames done before it closes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.checks import slam as checks
from benchmark.counts import roofline as rl
from benchmark.lib import scans
from benchmark.lib import trace as tr
from benchmark.reference import model as refm
from benchmark.reference.weights import read_tree, to_torch
from benchmark.lib.spec import REPO


def build_args(config: dict, out_dir: str):
    from deeppointmap_tpu_torch.config import config_from_dict

    tree = dict(config["model"])
    tree.update(infer_tgt=out_dir, weight="", checkpoint="",
                multi_thread=False, num_workers=2, profile=False)
    return config_from_dict(tree)


def ate(pg) -> float:
    """Umeyama-aligned ATE (m) of a pose graph's frames."""
    scans_ = sorted(pg.get_all_scans(), key=lambda s: s.timestep)
    p = np.stack([s.SE3_pred[:3, 3] for s in scans_])
    g = np.stack([s.SE3_gt[:3, 3] for s in scans_])
    mp, mg = p.mean(0), g.mean(0)
    U, _, Vt = np.linalg.svd((p - mp).T @ (g - mg))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    q = (p - mp) @ R.T + mg
    return float(np.sqrt(np.mean(np.sum((q - g) ** 2, 1))))


class Runner:
    """Sessions of one drive on one engine."""

    def __init__(self, args, engine, root: str, out_dir: str, traced: bool):
        from deeppointmap_tpu_torch.pipeline import infer

        self.infer = infer
        self.args, self.engine, self.root = args, engine, root
        self.out_dir, self.traced = out_dir, traced
        self.sessions = []   # per session: dict of what the window reads
        self.cap = None      # the check's Capture, told of each frame fed

    def _open(self):
        from deeppointmap_tpu_torch.data.dataset import BasicAgent
        from deeppointmap_tpu_torch.slam.system import SlamSystem

        self.engine.invalidate_device_cache()
        if self.cap is not None:
            self.cap.begin_session()
        agent = BasicAgent(root=self.root, reader="auto")
        agent.set_independent(self.infer.make_infer_transform(self.args))
        system = SlamSystem(self.args, self.engine, system_id=1,
                            logger_dir=self.out_dir)
        rec = dict(system=system, frame_s=[], done_at=[], fed=0,
                   opened=time.perf_counter())
        stamps = rec["stamps"] = []
        log = system.result_logger
        orig = log.record_perf

        def record_perf(name, seconds):
            stamps.append((name, time.perf_counter(), seconds))
            orig(name, seconds)
        log.record_perf = record_perf
        if self.traced:
            for mod, name in ((system.mapping, "process"),
                              (system.loop, "process"),
                              (system.odometry, "search_candidates")):
                setattr(mod, name, _spanned(getattr(mod, name),
                                            f"{type(mod).__name__}"))
        self.sessions.append(rec)
        return agent, system, rec

    def session(self, deadline: float, max_frames: int = 0) -> bool:
        """One drive, or what fits before `deadline` (perf_counter) ->
        whether the session ran to its end."""
        agent, system, rec = self._open()
        frames = self.infer.prefetch(agent)
        try:
            for i, data in enumerate(frames):
                if max_frames and i >= max_frames:
                    return False
                if self.cap is not None:
                    self.cap.due = i
                t0 = time.perf_counter()
                with tr.span("frame", self.traced):
                    system.step(data)
                t1 = time.perf_counter()
                rec["fed"] += 1
                if t1 > deadline:
                    return False
                rec["frame_s"].append(t1 - t0)
                rec["done_at"].append(t1)
            return True
        finally:
            frames.close()

    def window_records(self, t0: float, t1: float) -> dict:
        """What the per-layer readers take from the window's sessions."""
        frames, sums, frame_s, started = 0, {}, [], 0
        frames_of = []
        for rec in self.sessions:
            done = [t for t in rec["done_at"] if t0 <= t <= t1]
            if not done:
                continue
            started += 1
            frames += len(done)
            frames_of.append(len(done))
            frame_s += rec["frame_s"][:len(done)]
            for name, t, s in rec["stamps"]:
                if t0 <= t <= t1:
                    sums[name] = sums.get(name, 0.0) + s
        return dict(frames=frames, stage_s=sums, frame_s=frame_s,
                    sessions=started, frames_of=frames_of)


def _spanned(fn, name):
    def wrapped(*a, **kw):
        with tr.span(name, True):
            return fn(*a, **kw)
    return wrapped


def _scan_counts(root, frames_of, model, device):
    """The work counts of the window's frames, from the benchmark's own
    scans by the reference's filters: per drive frame (crop valid,
    in-radius pairs, survivors)."""
    pad = int(model["tpu"]["encoder_points"])
    voxel = float(model["transforms"]["VoxelSample"]["voxel_size"])
    need = sorted({i for n in frames_of for i in range(n)})
    stats = {}
    for i in need:
        pts, valid = refm.upload_points(scans.load_scan(root, i)[0], pad,
                                        voxel)
        stats[i] = refm.scan_stats(
            torch.tensor(pts[None], device=device),
            torch.tensor(valid[None], device=device), model["transforms"])
    return [stats[i] for n in frames_of for i in range(n)]


def _counts(args, model, stats, sessions, peaks):
    """slam_mfu's and the kernels' rooflines' work over the window: each
    frame's extraction, and the odometry registration of every frame but
    a session's first (against the 256-token bucket, with the information
    matrix). Scan-to-map, loop scoring and loop registration are not
    counted: a lower bound."""
    from deeppointmap_tpu_torch.pipeline.infer import (
        device_preprocess_config)

    pre = device_preprocess_config(args)
    tree = rl.Tree(model)
    tokens = rl._tokens(tree.encoder)
    n = int(model["tpu"]["encoder_points"])
    pairs = refm.num_pairs_for(tokens, tokens, float(
        model["slam_system"]["registration_sample_odometer"]))
    total, fps, knn = rl.Cost(), rl.Cost(), rl.Cost()
    for j, (crop, in_r, valid) in enumerate(stats):
        c = rl.ScanCounts((crop,), in_r, (valid,))
        ext = rl.extract_cost(tree, n, c, pre, rl.BF16)
        total = total + rl.total(ext)
        fps = fps + ext["fps"]
        knn = knn + ext["preprocess_sweep"] + ext["sa_level_knn"] \
            + ext["fp_3nn"]
    regs = len(stats) - sessions
    if regs > 0:
        mean_valid = int(np.mean([s[2] for s in stats]))
        reg = rl.register_cost(tree, tokens, n, mean_valid, pairs, rl.BF16)
        total = total + rl.total(reg) * regs
        knn = knn + reg["info_matrix"] * regs
    return dict(ops_s=total.seconds(peaks)[0], fps_bound_s=fps.bound(peaks),
                knn_bound_s=knn.bound(peaks))


def drive(seed: int, traf: dict) -> str:
    """The scans a run drives: the drive rendered once from the traffic's
    `render_seed`; the run's seed only picks where in the drive the
    sessions start (`cyclic_view`): every seed drives the same scans in
    another order."""
    root = scans.ensure_drive(int(traf["render_seed"]), traf["world"],
                              traf["render"], traf["trajectory"],
                              workers=int(traf.get("render_workers", 8)))
    lap = int(traf["trajectory"]["frames_per_lap"]) \
        * int(traf["trajectory"]["laps"])
    start = int(np.random.default_rng([int(seed) % (1 << 63), 3])
                .integers(0, lap))
    return scans.cyclic_view(root, start)


def run(cell, seed: int, seconds: float, trace: bool, device, controls=(),
        say=print) -> dict:
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.pipeline.infer import device_preprocess_config
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    cfg, traf = cell.config, cell.traffic
    model = cfg["model"]
    out_dir = os.path.join(scans.CACHE, "slam_out")
    args = build_args(cfg, out_dir)
    marks = [("start", time.perf_counter())]
    root = drive(seed, traf)
    say(f"drive: {root}")
    marks.append(("render", time.perf_counter()))
    weights = os.path.join(REPO, cfg["weights"])
    enc_sd, dec_sd = load_weights(args, weights)
    engine = InferenceEngine(args, enc_sd, dec_sd, device=device,
                             preprocess_cfg=device_preprocess_config(args))
    marks.append(("weights_engine", time.perf_counter()))
    runner = Runner(args, engine, root, out_dir, traced=False)
    runner.session(float("inf"), max_frames=int(traf["warm_frames"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    runner.sessions.clear()
    marks.append(("warm_session", time.perf_counter()))
    say("setup: " + ", ".join(f"{n} {t - p:.3f} s" for (_, p), (n, t)
                              in zip(marks, marks[1:])))

    cap = checks.Capture(engine, seed, **traf.get("sample", {}))
    cap.install()
    runner.cap = cap
    if trace:   # spans around the SLAM layer's calls into the engine
        for name in ("odometry_step", "odometry_step_async", "extract",
                     "register_scan_to_map_with_info_async",
                     "register_map_to_map_with_info_async",
                     "loop_scores_by_token"):
            setattr(engine, name, _spanned(getattr(engine, name),
                                           f"engine.{name}"))
    runner.traced = trace
    window = min(seconds, float(traf.get("trace_seconds", seconds))) \
        if trace else seconds
    prof = tr.profiler() if trace else None
    if prof is not None:
        prof.__enter__()
    cap.on = True
    t0 = time.perf_counter()
    deadline = t0 + window
    with tr.span("window", trace):
        while time.perf_counter() < deadline \
                and runner.session(deadline):
            pass
    t_close = time.perf_counter()
    cap.on = False
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if prof is not None:
        prof.__exit__(None, None, None)
    cap.remove()
    cap.engine = None
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    rec = runner.window_records(t0, deadline)
    n = rec["frames"]
    out = dict(window_start=t0, attempted=n, failed=0, memory_peak=peak)
    say(f"host: load {os.getloadavg()}, {len(os.sched_getaffinity(0))} "
        f"cores")
    say(f"window: {n} frames in {window:.3f} s ({rec['sessions']} "
        f"sessions, closed {t_close - deadline:.3f} s after the deadline); "
        f"sampled calls {cap.counts()}")
    for i, s in enumerate(runner.sessions):
        pg = s["system"].posegraph_map
        if len(pg.get_all_scans()) < 3:
            continue
        last = s["done_at"][-1] if s["done_at"] else s["opened"]
        say(f"session {i}: {s['fed']} frames fed, {len(s['done_at'])} done "
            f"in {last - s['opened']:.3f} s, "
            f"in the window, {pg.key_frame_num} keyframes, "
            f"{pg.loop_edge_num} loop edges, aligned ATE {ate(pg):.4f} m")
    e2e = {"slam_scans_per_s": n / window}
    if rec["frame_s"]:
        e2e["slam_frame_ms_p95"] = float(np.percentile(
            np.asarray(rec["frame_s"]) * 1e3, 95))
    out["e2e"] = e2e
    if trace:
        t_tr = time.perf_counter()
        summary = tr.summarize(prof)
        out["trace"] = summary
        peaks = rl.KNOWN_CARDS.get(torch.cuda.get_device_name(device)) \
            if device.type == "cuda" else None
        stats = _scan_counts(root, rec["frames_of"], model, device)
        rec["counts"] = _counts(args, model, stats, rec["sessions"],
                                peaks or rl.H100_SXM)
        rec["trace"] = summary
        rec["window_s"] = window
        rec["driver"] = "slam"
        rec["peaks_known"] = peaks is not None
        out["rec"] = rec
        say(f"trace read in {time.perf_counter() - t_tr:.3f} s: spans only "
            f"{summary['spans_only']}, {summary['host_events']} host events, "
            f"{summary['launches']} launches")
    del prof
    # the program's state goes before the reference runs
    runner.sessions.clear()
    del runner, engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tree = to_torch(read_tree(weights), device)
    t_check = time.perf_counter()
    nums, ctl, sizes = checks.compare(cap, tree, model, root, device,
                                      controls)
    say(f"checked: {sizes} in {time.perf_counter() - t_check:.3f} s")
    out["numbers"] = nums
    out["controls"] = ctl
    return out
