"""Long-stream scale run: stream many frames through the whole pipelined
SLAM system (loops on) and follow how host cost and memory grow with the
graph (the port's counterpart of scripts/scale_run.py; the CLI over it is
scripts/scale_run_torch.py, and bench_torch.py's scale block runs 300
frames of it).

World: closed laps of 96 frames whose radius drifts lap to lap, so the
stream keeps revisiting (loop closures fire throughout) while the geometry
varies; the demo-width model (artifacts/synthetic_demo) at demo_args with
the gates below. Every block of frames records scans/s, the stage ms, the
host RSS and, on a CUDA device, the card's allocated and peak allocated
memory (its counterpart of the RSS: the token-keyed device cache and the
pose graph's device tensors live there).
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WEIGHTS = os.path.join(REPO, "artifacts/synthetic_demo/weights_final.msgpack")


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def device_mb(device) -> tuple:
    """(allocated MB, peak allocated MB) on a CUDA device, else (None,
    None)."""
    if torch.device(device).type != "cuda":
        return None, None
    return (round(torch.cuda.memory_allocated(device) / 2 ** 20, 1),
            round(torch.cuda.max_memory_allocated(device) / 2 ** 20, 1))


def drifting_laps(n_frames: int, frames_per_lap: int = 96,
                  base_radius: float = 25.0, drift: float = 3.0):
    """Closed laps whose radius drifts lap to lap: revisits overlap but
    never repeat exactly."""
    from deeppointmap_tpu_torch.utils import se3 as se3m

    poses = []
    for k in range(n_frames):
        lap = k // frames_per_lap
        a = 2 * np.pi * (k % frames_per_lap) / frames_per_lap
        r = base_radius + drift * np.sin(2 * np.pi * lap / 7.0)
        heading = a + np.pi / 2
        R = np.array([[np.cos(heading), -np.sin(heading), 0],
                      [np.sin(heading), np.cos(heading), 0],
                      [0, 0, 1.0]])
        t = np.array([r * np.cos(a), r * np.sin(a), 1.5])
        poses.append(se3m.se3(R, t))
    return poses


def build_world(root: str, n_frames: int) -> None:
    """The drifting-laps scene (world seed 0, 2000 points a scan) as npz,
    kept while its world_meta.json fingerprint matches."""
    from deeppointmap_tpu_torch.data.synthetic import (make_world,
                                                       write_npz_sequence)

    agent_dir = os.path.join(root, "scene0", "0")
    meta = dict(kind="drifting_laps", frames=n_frames, max_points=2000)
    mpath = os.path.join(root, "scene0", "world_meta.json")
    try:
        with open(mpath) as f:
            if json.load(f) == meta and os.path.isdir(agent_dir):
                return
    except (OSError, ValueError):
        pass
    shutil.rmtree(os.path.join(root, "scene0"), ignore_errors=True)
    rng = np.random.default_rng(0)
    world = make_world(rng)
    write_npz_sequence(root, world, drifting_laps(n_frames), rng=rng,
                       max_points=2000)
    with open(mpath, "w") as f:
        json.dump(meta, f)
    print(f"world: {n_frames} frames over {n_frames // 96} drifting laps",
          flush=True)


def scale_args(root: str, out: str, retain_pcd: bool = False):
    """demo_args with the scale run's gates. Loop and drop tuning follows
    the reference's production rule (tight drop gates, a small trust zone),
    scaled to this stream: ~24 keyframes a lap put a one-lap-ago revisit at
    graph distance ~24, so trust2 = trust_range x 10 must stay below it.
    The drop gates sit between the demo model's normal registrations (rmse
    ~0.75, confidence ~0.65) and its failures (rmse >= 1.4, confidence <=
    0.52). Loop attempts are rate-limited (they share the device with the
    odometer). Good revisit edges of the demo model read confidence
    0.25-0.34 and junk ones 0.13-0.17, so the loop gate is 0.25."""
    from deeppointmap_tpu_torch.pipeline.demo import demo_args

    args = demo_args(root, out)
    args.infer_src = [os.path.join(root, "scene0", "0")]
    args.slam_system.loop_detection_trust_range = 2
    args.slam_system.edge_rmse_drop = 1.1
    args.slam_system.edge_confidence_drop = 0.5
    args.slam_system.loop_detection_attempt_gap = 2
    args.slam_system.loop_detection_confidence_acpt_threshold = 0.25
    args.tpu["retain_nonkeyframe_pcd"] = bool(retain_pcd)
    return args


def _round_stats(stats: dict) -> dict:
    return {k: round(v, 3) if isinstance(v, float) else v
            for k, v in stats.items()}


def run_scale(frames: int = 1200, block: int = 100,
              root: str = os.path.join(REPO, "log_infer/scale/world"),
              out: str = os.path.join(REPO, "log_infer/scale/out"),
              retain_pcd: bool = False, quiet: bool = False,
              device: str = "cuda") -> dict:
    """Stream `frames` multi-lap frames through the pipelined SLAM system
    and return the summary dict (the JAX run_scale's keys, plus the
    device's memory beside each RSS figure)."""
    from deeppointmap_tpu_torch.data.dataset import BasicAgent
    from deeppointmap_tpu_torch.pipeline.common import (load_weights,
                                                        require_device)
    from deeppointmap_tpu_torch.pipeline.infer import (
        device_preprocess_config, make_infer_transform, prefetch)
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine
    from deeppointmap_tpu_torch.slam.system import SlamSystem
    from deeppointmap_tpu_torch.utils.evaluation import ate_rmse

    device = require_device(device)
    build_world(root, frames)
    os.makedirs(out, exist_ok=True)

    def say(msg):
        if not quiet:
            print(msg, flush=True)

    args = scale_args(root, out, retain_pcd)
    enc_sd, dec_sd = load_weights(args, WEIGHTS)
    engine = InferenceEngine(args, enc_sd, dec_sd, device=device,
                             preprocess_cfg=device_preprocess_config(args))
    if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(engine.device)
    agent = BasicAgent(root=args.infer_src[0], reader="auto")
    agent.set_independent(make_infer_transform(args))
    system = SlamSystem(args, engine, system_id=1, logger_dir=out)

    def record(n_frames, scans_per_sec, stages):
        pg = system.posegraph_map
        dev_mb, dev_max_mb = device_mb(engine.device)
        return dict(frames=n_frames, scans_per_sec=scans_per_sec,
                    rss_mb=round(rss_mb(), 1), device_mb=dev_mb,
                    device_max_mb=dev_max_mb, keyframes=pg.key_frame_num,
                    loop_edges=pg.loop_edge_num, stages_ms=stages)

    system.MT_Init()
    blocks = []
    t_block = time.perf_counter()
    n = min(len(agent), frames)
    for i, data in enumerate(prefetch(agent)):
        if i >= n:
            break
        system.MT_Step(data)
        # sensor-paced producer: stay <= 8 frames ahead of the mapping
        # stage, so that a block's time is the pipeline's throughput and
        # not the enqueue rate (_mapped_count counts every consumed frame,
        # drops included); a crashed stage ends the wait (MT_Wait raises)
        while system._mapped_count < i - 8 and not system._mt_errors:
            time.sleep(0.001)
        if (i + 1) % block == 0:
            dt = time.perf_counter() - t_block
            t_block = time.perf_counter()
            stages = {k: round(v[0] * 1000, 2)
                      for k, v in system.result_logger.log_time(
                          block).items()}
            blk = record(i + 1, round(block / dt, 2), stages)
            blocks.append(blk)
            say(json.dumps(blk))
    system.MT_Done()
    system.MT_Wait()

    pg = system.posegraph_map
    scans = sorted(pg.get_all_scans(), key=lambda s: s.timestep)
    pred = np.stack([s.SE3_pred for s in scans])
    gt = np.stack([s.SE3_gt for s in scans])
    ate = float(ate_rmse(pred, gt, align=True))

    # per-frame relative translation error (pred against gt consecutive
    # deltas): WHERE tracking jumps, registration failures (isolated
    # spikes) apart from optimizer shifts (spikes at loop events)
    dp = np.linalg.norm(np.einsum(
        "nij,njk->nik", np.linalg.inv(pred[:-1]), pred[1:])[:, :3, 3]
        - np.einsum("nij,njk->nik", np.linalg.inv(gt[:-1]),
                    gt[1:])[:, :3, 3], axis=1)
    worst = np.argsort(dp)[::-1][:10]
    by_dst = {e.dst_scan_token: e for e in pg.get_all_edges()
              if e.type == "odom"}
    diag = []
    for i in worst:
        s = scans[i + 1]          # dp[i] is the delta INTO scans[i+1]
        e = by_dst.get(s.token)
        diag.append(dict(
            ts=int(s.timestep), err_m=round(float(dp[i]), 3),
            rmse=round(float(e.rmse), 3) if e is not None else None,
            conf=round(float(e.confidence), 3)
            if e is not None and e.confidence is not None else None,
            cand_ts=int(pg.get_scanpack(e.src_scan_token).timestep)
            if e is not None else None))
    say("worst frame-to-frame errors: " + json.dumps(diag))
    say(f"staleness fallback transitions: {system._staleness_events}")
    loop_ts = [[int(pg.get_scanpack(e.src_scan_token).timestep),
                int(pg.get_scanpack(e.dst_scan_token).timestep)]
               for e in pg.get_all_edges() if e.type == "loop"]
    say("loop edges (src ts, dst ts): " + json.dumps(loop_ts))
    say("loop gate stats: " + json.dumps(_round_stats(system.loop.stats)))
    say("recent loop edges (conf, rmse): " + json.dumps(
        [[round(c, 3), round(r, 3)] for c, r in system.loop.recent_edges]))

    if not blocks:   # fewer frames than one block
        blocks = [record(pg.all_frame_num, -1.0, {})]
    first, last = blocks[0], blocks[-1]
    summary = dict(
        frames=pg.all_frame_num, keyframes=pg.key_frame_num,
        # frames handed to MT_Step, and those the mapping stage consumed
        # (drops included; every frame after the first)
        frames_streamed=n, frames_mapped=system._mapped_count,
        loop_edges=pg.loop_edge_num, ate_m=round(ate, 4),
        # the loop pipeline must keep verifying revisits on this stream;
        # false means detection, map-to-map registration or verification
        # regressed
        loop_floor_ok=pg.loop_edge_num >= 2,
        loop_gate_stats=_round_stats(system.loop.stats),
        retain_nonkeyframe_pcd=bool(retain_pcd),
        scans_per_sec_first_block=first["scans_per_sec"],
        scans_per_sec_last_block=last["scans_per_sec"],
        rss_first_block_mb=first["rss_mb"], rss_last_block_mb=last["rss_mb"],
        rss_growth_mb=round(last["rss_mb"] - first["rss_mb"], 1),
        device_first_block_mb=first["device_mb"],
        device_last_block_mb=last["device_mb"],
        device_growth_mb=None if first["device_mb"] is None
        else round(last["device_mb"] - first["device_mb"], 1),
        device_max_mb=last["device_max_mb"],
        device=str(engine.device), blocks=blocks)
    say("SUMMARY " + json.dumps(
        {k: v for k, v in summary.items() if k != "blocks"}))
    return summary
