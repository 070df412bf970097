#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeppointmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [OUT_DIR]

Phases, in order, each printing one JSON line:
  device  the card (nvidia-smi name and power limit); fails without CUDA.
  build   nvcc builds the four kernels from csrc/, all at once.
  k1      K1 (FPS) against its plain version at the encoder's five stage
          shapes (B=1) and at 16384 -> 4096 with B=4: identical indices;
          also on duplicated points (ties), on a scan that does not fill
          the cluster's partition, and with fewer valid points than k.
  k2      K2 (kNN + radius moments) against its plain version at every
          shape a path gives it and at the sweep-reuse width (k = 41 with
          moments): identical neighbour sets and dist2, cnt equal and
          moments within one float32 ulp; also at k = 65 and 128, on
          duplicated points, and with fewer valid points than k.
  k3      K3 (radius moments over all points) against its plain version at
          (1, 16384, r 0.5 m), at a small odd shape and at the seams of its
          class-major layout (`seam_scans`): cnt equal, s and S6 within one
          float32 ulp.
  k4_routes  the preprocess sweep of frame 0 under each route of
          ops/normals.filter_sweep (K2 with moments; K4; K3 + K2 without
          moments) at the filters' width (k 17) and the sweep-reuse width
          (k 41): the sweep's time, and the filter survivors on which each
          route differs from the K2 route.
  k4      K4 (fused sweep) against its plain version at (1, 16384, k 41,
          r 0.5 m), at a small odd shape and at the layout's seams (k = 1,
          17, 41, 128): indices and dist2 identical, moments as K3; recall
          against K2's exact neighbours at k = 17 and 41 on a synthetic scan
          must be >= 0.97; its time at k = 17 beside k = 41, and K2's at
          k = 41.
  main    the inference engine at full width (DeepPointMap-B,
          configs/infer/sample.yaml, trained weights from
          artifacts/full_size_occ_v2) on synthetic scans: extract, odometry
          frame to frame, register_with_info, loop_scores.
  slam_a  single-agent SLAM through pipeline.infer.run_sequence ->
          SlamSystem.step on 120 synthetic scans written as KITTI .bin
          files, with tpu.sweep_reuse and USE_FUSED_SWEEP: K4 serves the
          filters and the encoder's first stage (no K2 launch there). Engine
          entry points the run did not reach are then driven directly.
  slam_b  16 frames, same entry point, sweep reuse off, USE_FUSED_MOMENTS:
          K3 beside K2 without moments; the share of normals that match a
          float64 PCA, from K2's moments and from K3's.
  slam_mt slam_a's configuration with `multi_thread` (the pipelined
          SlamSystem, odometer depth 1) through run_sequence on the same
          120 frames: scans/s beside slam_a's, the stage medians, frames
          accepted, keyframes, staleness events, the ATE (not gated); every
          frame accounted for, no stage error, K4 launched once a frame.
          Then 16 frames again with torch's sync debug mode on, for the
          synchronisations a frame on the odometer thread.
  slam_robust  120 frames single-threaded with `tpu.robust_register` (the
          RANSAC solve) under sample.yaml's own edge gates: the ATE, frames
          accepted and loop edges (printed, not gated); one ransac_kabsch
          call's time and synchronisations.
  sequence_parallel  two 16-frame sequences through pipeline.infer's
          run_inference with `tpu.sequence_parallel: 2` (one engine on one
          card) and without: the trajectory files must agree.
  host_chain  8 frames with `tpu.device_preprocess: false` (the host
          transform chain) on the GPU and on the CPU: the same exit codes,
          poses within 0.05 deg and 1 cm; the host chain's ms a frame.
  encoder_options  one frame's extract with the voxel sampler, the knn
          querier and the ball querier, GPU against CPU: descriptors relerr
          <= 1e-3; their ms.
  accuracy  the JAX package's accuracy block on the port: the two-lap world
          of scripts/train_full_size.py build_eval_world (192 frames, seed
          0, artifacts/full_size_occ_v2/render_meta.json) as an npz
          sequence, single-agent with a copy of full_eval_args (no
          outlier / low-pass filter, min_dis 0, the RANSAC solve, loop
          gates 0.6 / 0.3): the Umeyama-aligned ATE with loops on and off,
          the unaligned ATE, frames accepted and loop edges; once more
          with sample.yaml's filter chain; the JAX package's TPU numbers
          beside them, labelled as such. Not gated.
  ma_inproc  pipeline/infer_multiagents.main in process (3 agent threads and
          the cloud on one engine) with configs/infer/ma_synthetic.yaml on
          that world: cloud loop edges and the loop funnel, the merged and
          per-agent ATE and the largest seam over the shared frames
          (scripts/ma_quality.py's scoring), frames a second over all
          agents, wall seconds; K1 and K2 must have launched. Not gated.
  ma_tcp  the same over TCP with three agent worker processes on the card,
          on the first 48 frames, and in process on the same frames: every
          worker exits 0, the cloud holds scans of agents 1-3, and each
          agent's keyframes equal the in-process run's.
  viewer  utils/visualization.show_pcd of ma_inproc's merged map (its
          densest 0.5 m voxels) with normals estimated on the card: K2 at
          that shape held to its plain version first, then launched by the
          viewer; the file holds a unit normal for every point.
  cpu     frames 0-2 of `main` again through the same engine on the CPU (the
          plain versions), and frames 0-2 of slam_a through a CPU
          SlamSystem, held to the GPU results.
The slam_* summaries give the unaligned and the aligned ATE (utils/
evaluation). The launch counts are set to 0 just before each path (main,
slam_a, slam_b and the paths of the phases after them) and read just after
(a TCP worker's launches are its own process's and are not read); every
kernel of a path must have launched in it, at shapes held against the
plain versions in k1-k4 (the pipelined mode's warm-up extracts a batch of
four, so those shapes are checked at B = 4 too). Then one JSON line with
every kernel's numbers, the nvidia-smi line, and the last line {"ok": true,
"device": {...}}; with OUT_DIR, the kernel entries also go to
OUT_DIR/chip_smoke.json and every JSON line to OUT_DIR/chip_smoke.log. Any
failure raises and the script exits non-zero. TF32 is off throughout: distances at +-60 m need full f32. A
kernel's time is that of a run of launches between one pair of CUDA events
(`timed`), with the wrapper's host time a call beside it.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

SEED = 0
N_PAD = 16384
N_FRAMES = 8
CPU_FRAMES = 3
SLAM_A_FRAMES = 120
SLAM_B_FRAMES = 16
#: the JAX package's accuracy world: two laps of 96 frames
#: (scripts/train_full_size.py build_eval_world)
ACC_FRAMES = 192
#: the TCP phase's depth: the first frames of that world
TCP_FRAMES = 48
#: agents of pipeline/infer_multiagents
MA_AGENTS = 3
#: the merged map in the viewer phase: its densest 0.5 m voxels, at most
VIEWER_POINTS = 32768
HOST_FRAMES = 8
SYNC_FRAMES = 16
#: the pipelined mode's warm-up extracts a batch of this many scans
#: (engine.extract_chunk)
WARMUP_BATCH = 4
WEIGHTS = "artifacts/full_size_occ_v2/weights_final.msgpack"
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = {"fps": "deeppointmap_tpu/ops/pallas_fps.py:111",
            "knn": "deeppointmap_tpu/ops/pallas_knn.py:192",
            "moments": "deeppointmap_tpu/ops/pallas_moments.py:94",
            "sweep": "deeppointmap_tpu/ops/pallas_sweep.py:147"}
SOURCES = {name: f"deeppointmap_tpu_torch/csrc/{name}.cu" for name in REPLACES}

#: configs/infer/sample.yaml (the DeepPointMap-B model) as a dict; the
#: `tpu:` tree is laid over TPU_DEFAULTS by config_from_dict
CONFIG = dict(
    transforms={
        "VoxelSample": {"voxel_size": 0.3, "retention": "first"},
        "DistanceSample": {"min_dis": 1.0, "max_dis": 60.0},
        "OutlierFilter": {"nb_neighbors": 10, "std_ratio": 3.0},
        "LowPassFilter": {"normals_radius": 0.5, "normals_num": 16,
                          "filter_std": 2.0, "flux": 4, "max_remain": -1},
        "CoordinatesNormalization": {"ratio": 60.0},
        "ToTensor": {"padding_to": -1},
    },
    encoder=dict(npoint=[4096, 1024, 256, 64, 16],
                 radius_list=[[0.05, 0.1], [0.1, 0.2], [0.2, 0.4, 0.4],
                              [0.4, 0.8], [0.8, 1.6]],
                 nsample_list=[[32, 32], [32, 32], [32, 32, 32], [32, 32],
                               [16, 16]],
                 in_channel=3, out_channel=128, width=16, expansion=4,
                 upsample_layers=2, sample=[{"type": "fps"}] * 5, norm="LN",
                 bias=True),
    decoder=dict(in_channel=128, model_channel=256, attention_layers=3),
    loss=dict(tau=0.1, eps_offset=2.0),
    slam_system=dict(
        coor_scale=60, odometer_candidates_num=1,
        registration_sample_odometer=0.5, edge_confidence_drop=0.60,
        edge_rmse_drop=0.50, max_continuous_drop_scan=5,
        continuous_drop_scan_strategy="recover", key_frame_distance="auto",
        key_frame_distance_0=10, enable_s2m_adjust=True,
        registration_sample_mapping=0.5, enable_loop_closure=True,
        loop_detection_gap=0, loop_detection_transaction_gap=10.0,
        loop_detection_trust_range=3, loop_detection_gnss_distance=-1,
        loop_detection_pred_distance=100.0, loop_detection_rotation_min=30.0,
        loop_detection_translation_min=10.0,
        loop_detection_prob_acpt_threshold=0.7,
        loop_detection_candidates_num=1, registration_sample_loop=0.5,
        loop_detection_confidence_acpt_threshold=0.6,
        enable_global_optimization=True, global_optimization_gap=0),
    tpu=dict(encoder_points=N_PAD, reg_buckets=[256, 512, 1024, 2048, 4096],
             loop_batch_buckets=[1, 2, 4, 8, 16, 32, 64], bf16=True),
)
#: Edge gates and keyframe spacing for the synthetic world. sample.yaml's
#: gates (confidence 0.6, rmse 0.5 m, keyframes every ~10 m) are calibrated
#: to KITTI with the upstream weights. This artifact, with the plain
#: weighted Kabsch solve (phase slam_robust runs the RANSAC solve under
#: sample.yaml's gates), registers the occluded synthetic scans 3.3 m apart at
#: rmse 1.4-4.6 m (so does the JAX package: tests/test_torch_full_width.py)
#: and underestimates the motion between scans further apart:
#: under sample.yaml's gates four frames in five are dropped, and with wide
#: keyframe spacing the map never grows. So every accepted frame that moved
#: 2 m becomes a keyframe, and only edges beyond 10 m rmse are dropped.
SYNTHETIC_GATES = dict(edge_confidence_drop=0.0, edge_rmse_drop=10.0,
                       key_frame_distance=2.0)
#: the gates configs/infer/ma_synthetic.yaml pairs with the RANSAC solve
#: (calibrated to its coverage-scaled rmse)
RANSAC_GATES = dict(edge_confidence_drop=0.3, edge_rmse_drop=1.0,
                    key_frame_distance="auto", key_frame_distance_0=4.0)
#: scripts/train_full_size.py full_eval_args: the JAX package's accuracy
#: block (no outlier / low-pass filter, no distance floor, the RANSAC solve,
#: loop gates 0.6 / 0.3), for the same model trees as CONFIG
EVAL_TRANSFORMS = {
    "VoxelSample": {"voxel_size": 0.3, "retention": "first"},
    "DistanceSample": {"min_dis": 0.0, "max_dis": 60.0},
    "CoordinatesNormalization": {"ratio": 60.0},
    "ToTensor": {"padding_to": -1},
}
EVAL_SLAM = dict(
    coor_scale=60, odometer_candidates_num=1,
    registration_sample_odometer=0.5, edge_confidence_drop=0.3,
    edge_rmse_drop=1.0, max_continuous_drop_scan=5,
    continuous_drop_scan_strategy="recover", key_frame_distance="auto",
    key_frame_distance_0=4.0, enable_s2m_adjust=True,
    registration_sample_mapping=0.5, enable_loop_closure=True,
    loop_detection_gap=0, loop_detection_transaction_gap=10.0,
    loop_detection_trust_range=3, loop_detection_gnss_distance=-1,
    loop_detection_pred_distance=100.0, loop_detection_rotation_min=30.0,
    loop_detection_translation_min=10.0,
    loop_detection_prob_acpt_threshold=0.6, loop_detection_candidates_num=1,
    registration_sample_loop=0.5,
    loop_detection_confidence_acpt_threshold=0.3,
    enable_global_optimization=True, global_optimization_gap=0)
#: the JAX package's numbers on that world and these args, for reference
#: only: TPU, as BASELINE.md records them (:502-504, 550-590), not the port's
JAX_TPU_REFERENCE = dict(
    source="JAX package on a TPU, as recorded in BASELINE.md",
    ate_aligned_m=4.52, ate_aligned_no_loop_m=6.06, ma_merged_ate_m=3.25,
    ma_cross_agent_loop_edges="80-83")
#: artifacts/full_size_occ_v2/render_meta.json
WORLD = dict(n_clusters=1200, extent=120.0, pts_per_cluster=800)
RENDER = dict(sensor_range=45.0, max_points=16384, occlusion_bins=512)
TRAJ = dict(radius=50.0, frames_per_lap=96)


#: with OUT_DIR, every emitted line is also appended to this file, so the
#: whole record survives when only the end of the output is kept
EMIT_COPY: list = []


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for path in EMIT_COPY:
        with open(path, "a") as f:
            f.write(line + "\n")


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def rotation_deg(A, B) -> float:
    chord = np.linalg.norm(np.asarray(A, np.float64) - np.asarray(B,
                                                                   np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, chord / (2 * np.sqrt(2))))))


def timed(torch, fn, reps: int, rounds: int = 3) -> tuple[float, float]:
    """(device ms a call, host microseconds a call) of `fn`: after a
    warm-up, `reps` calls between ONE pair of CUDA events, so that the
    wrapper's host time overlaps the device's work as it does on a path;
    the median of `rounds` such runs. The host time is the clock around the
    calls before anything waits for the device: where it is about the
    device's figure, the row shows the wrapper, not the kernel."""
    fn()
    torch.cuda.synchronize()
    ms, host = [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) / reps * 1e6)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / reps)
    return float(np.median(ms)), float(np.median(host))


def timed_ms(torch, fn, reps: int, rounds: int = 3) -> float:
    return timed(torch, fn, reps, rounds)[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def render_raw(syn, n_frames: int):
    """n_frames raw-meter scans (lists of (n_i, 3) arrays) along the circle,
    and their ground-truth poses."""
    rng = np.random.default_rng(SEED)
    world = syn.make_world(rng, **WORLD)
    poses = syn.circle_trajectory(TRAJ["frames_per_lap"], TRAJ["radius"])
    poses = [poses[i % len(poses)] for i in range(n_frames)]
    return [syn.render_scan(world, p, rng=rng, **RENDER) for p in poses], \
        poses


def render_scans(syn, voxel_idx, raw=None, n_frames: int = N_FRAMES):
    """The first n_frames scans voxelized at 0.3 m and padded:
    (n_frames, N_PAD, 3) raw meters, validity and the ground-truth poses."""
    scans, poses = raw if raw is not None else render_raw(syn, n_frames)
    pts = np.zeros((n_frames, N_PAD, 3), np.float32)
    valid = np.zeros((n_frames, N_PAD), bool)
    for i in range(n_frames):
        xyz = scans[i][voxel_idx(scans[i], 0.3, "first")][:N_PAD]
        pts[i, :len(xyz)] = xyz
        valid[i, :len(xyz)] = True
    return pts, valid, poses[:n_frames]


def write_bins(scans, root: str) -> None:
    """Scans as KITTI velodyne files (N, 4) float32 x/y/z/intensity."""
    os.makedirs(root, exist_ok=True)
    for i, xyz in enumerate(scans):
        np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)],
                       1).astype(np.float32).tofile(
            os.path.join(root, f"{i:06d}.bin"))


def write_npz(scans, poses, root: str) -> str:
    """Scans with their ground-truth poses as an npz sequence, the layout
    of data/synthetic.write_npz_sequence (which renders them itself)."""
    os.makedirs(root, exist_ok=True)
    for i, (xyz, pose) in enumerate(zip(scans, poses)):
        np.savez(os.path.join(root, f"{i}.npz"), lidar_pcd=xyz,
                 ego_rotation=pose[:3, :3].astype(np.float32),
                 ego_translation=pose[:3, 3:].astype(np.float32))
    return root


def split_range(total: int, n_agents: int, index: int) -> tuple:
    """Frames [start, end) of agent `index` (0-based), as
    data/dataset.BasicAgent slices a sequence (5% overlap)."""
    ratio = 1.0 / n_agents
    start = max(ratio * index - 0.05, 0.0)
    end = min(ratio * (index + 1) + 0.05, 1.0)
    return int(total * start), int(total * end)


def ma_quality(evaluation, pg, gt) -> dict:
    """The scoring of scripts/ma_quality.py on a merged graph: tokens map
    to global frames through the agents' slices; the merged ATE keeps the
    first agent's estimate of each frame; per-agent ATE; the seams, where
    two agents estimated the same frame. ATEs Umeyama-aligned."""
    total = len(gt)
    rows = []
    for s in pg.get_all_scans():
        agent, ts = s.token >> 16, s.token & 0xFFFF
        if 1 <= agent <= MA_AGENTS:
            g = split_range(total, MA_AGENTS, agent - 1)[0] + ts
            if g < total:
                rows.append((g, agent, s.SE3_pred))
    rows.sort(key=lambda r: (r[0], r[1]))
    first = {}
    for g, _, T in rows:
        first.setdefault(g, T)
    frames = sorted(first)
    out = dict(vertices=len(rows), frames_covered=len(frames),
               frames_total=total,
               merged_ate_m=evaluation.ate_rmse(
                   np.stack([first[g] for g in frames]), gt[frames]))
    for a in range(1, MA_AGENTS + 1):
        sub = [(g, T) for g, ag, T in rows if ag == a]
        if len(sub) >= 3:
            out[f"agent{a}_ate_m"] = evaluation.ate_rmse(
                np.stack([T for _, T in sub]), gt[[g for g, _ in sub]])
            out[f"agent{a}_frames"] = len(sub)
    by_frame = collections.defaultdict(dict)
    for g, a, T in rows:
        by_frame[g][a] = T
    seam_t, seam_r = [], []
    for d in by_frame.values():
        agents = sorted(d)
        for a, b in zip(agents, agents[1:]):
            D = np.linalg.inv(d[a]) @ d[b]
            seam_t.append(float(np.linalg.norm(D[:3, 3])))
            seam_r.append(rotation_deg(D[:3, :3], np.eye(3)))
    out.update(seam_frames=len(seam_t),
               seam_trans_max_m=max(seam_t, default=None),
               seam_rot_max_deg=max(seam_r, default=None))
    return out


# ------------------------------------------------------------------- K1
def check_fps(torch, sampling, xyz, valid, k):
    """One K1 shape against the plain version, every slot of it (beyond the
    valid points both repeat index 0); returns its entry."""
    b, n, _ = xyz.shape
    idx, sel = sampling.batched_fps(xyz, valid, k)
    ref = sampling.farthest_point_sampling_plain(xyz, valid, k)
    torch.cuda.synchronize()
    err = int((idx - ref).abs().max())
    if err != 0:
        raise AssertionError(f"K1 differs from its plain version at "
                             f"B={b} N={n} k={k}")
    ms, host_us = timed(torch, lambda: sampling.fps_cuda(xyz, valid, k), 10)
    plain_ms = timed_ms(
        torch, lambda: sampling.farthest_point_sampling_plain(xyz, valid, k),
        1, 1)
    # each of the k-1 steps: 3 sub, 3 mul, 2 add, 1 min per valid point
    # (an invalid point is never a candidate)
    bound_ms, by = bound(b * n * 13 + b * k * 8,
                         9.0 * float(valid.sum()) * (k - 1))
    return dict(name="fps", shape=list(sampling.fps_shape(b, n, k)),
                valid_points=int(valid.sum()), route="cuda",
                source=SOURCES["fps"], replaces=REPLACES["fps"],
                max_abs_err=float(err), ms=ms, host_us=host_us,
                plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


def odd_fps_cases(torch, dev):
    """K1 off the paths' shapes: (name, xyz, valid, k) with every point
    twice (min-distance ties and zero distances), with a scan that leaves
    the cluster's last blocks short, and with fewer valid points than k."""
    g = np.random.default_rng(SEED + 2)

    def cloud(b, n, n_valid):
        xyz = g.normal(size=(b, n, 3)).astype(np.float32)
        valid = np.zeros((b, n), bool)
        for i in range(b):
            valid[i, g.permutation(n)[:n_valid]] = True
        return xyz, valid

    ties, ties_v = cloud(2, 6000, 6000)
    ties[:, 3000:] = ties[:, :3000]
    ragged, ragged_v = cloud(1, 10001, 9000)
    few, few_v = cloud(3, 5000, 300)
    small, small_v = cloud(2, 700, 50)
    t = lambda x: torch.from_numpy(x).to(dev)
    return [("ties", t(ties), t(ties_v), 1500),
            ("ragged", t(ragged), t(ragged_v), 2500),
            ("few_valid", t(few), t(few_v), 1250),
            ("few_valid_one_block", t(small), t(small_v), 175)]


# ------------------------------------------------------------------- K2
def check_knn(torch, nb, points, valid, centers, k, radius):
    """One K2 shape against the plain version; returns its entry.
    Tolerances: identical neighbour sets but for exact ties, dist2 relerr
    <= 1e-5 (the two are built to give the same bits; max_abs_err reports
    what they gave); cnt equal, s and S6 within one float32 ulp."""
    b, n, _ = points.shape
    s = centers.shape[1]
    got = nb.knn_cuda(points, centers, k, valid, radius)
    ref = nb.knn_plain(points, centers, k, valid, radius)
    torch.cuda.synchronize()
    got = [x.cpu().numpy() for x in got]
    ref = [x.cpu().numpy() for x in ref]
    same = np.all(np.sort(got[0], -1) == np.sort(ref[0], -1), -1)
    for r in zip(*np.nonzero(~same)):
        kth = ref[1][r][-1]
        diff = set(got[0][r]) ^ set(ref[0][r])
        d = dict(zip(got[0][r], got[1][r])) | dict(zip(ref[0][r], ref[1][r]))
        if any(d[i] != kth for i in diff):
            raise AssertionError(f"K2 neighbour sets differ at {r}")
    if relerr(got[1], ref[1]) > 1e-5:
        raise AssertionError("K2 dist2 differs from its plain version")
    if radius > 0:
        check_moment_values(got[2:], ref[2:], "K2")
    err = max(float(np.max(np.abs(a.astype(np.float64) - c)))
              for a, c in zip(got, ref))
    ms, host_us = timed(torch, lambda: nb.knn_cuda(points, centers, k, valid,
                                                   radius), 20)
    plain_ms = timed_ms(torch, lambda: nb.knn_plain(points, centers, k,
                                                    valid, radius), 2, 1)

    def library():
        d = torch.cdist(centers, points)
        d = d.masked_fill(~valid[:, None, :], float("inf"))
        return torch.topk(d, k, dim=-1, largest=False)

    library_ms = timed_ms(torch, library, 10)
    # 8 FLOPs for |c|^2 - 2 c.p + |p|^2 of each center with each valid
    # point (an invalid point is no neighbour of anything); with moments 16
    # more for each in-radius pair (this run's counts)
    flops = 8.0 * s * float(valid.sum())
    nbytes = b * n * 13 + b * s * 12 + b * s * k * 12
    if radius > 0:
        flops += 16.0 * float(got[2].sum())
        nbytes += b * s * 40
    bound_ms, by = bound(nbytes, flops)
    return dict(name="knn", shape=list(nb.knn_shape(b, n, s, k, radius)),
                valid_points=int(valid.sum()), route="cuda",
                source=SOURCES["knn"], replaces=REPLACES["knn"],
                max_abs_err=err, ms=ms, host_us=host_us, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by=by, library_ms=library_ms)


def knn_inputs(torch, dev, scan_pts, scan_valid, n, s, radius, seed):
    """Inputs at one K2 shape: a real scan in raw meters where the shape
    carries moments or is the scan itself; else normalized subsets."""
    g = np.random.default_rng(seed)
    if n == N_PAD:
        pts, valid = scan_pts, scan_valid
    else:
        keep = g.choice(np.nonzero(scan_valid)[0], n, replace=False)
        pts, valid = scan_pts[keep] / 60.0, np.ones(n, bool)
    if s == n:
        centers = pts
    else:
        ci = g.choice(np.nonzero(valid)[0], s, replace=s > valid.sum())
        centers = pts[ci] + g.normal(0, 0.05 if n == N_PAD else 0.002,
                                     (s, 3))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)[None]).to(dev)
    return (t(pts.astype(np.float32)), t(valid),
            t(np.asarray(centers, np.float32)))


def odd_knn_cases(torch, dev, scan_pts, scan_valid):
    """K2 off the paths' shapes: (name, points, valid, centers, k, radius)
    at k = 65 and 128 (beyond the earlier limit of 64), on points that all
    occur twice (exact distance ties), and with fewer valid points than k,
    the last two with moments and a center count that is no multiple of a
    warp's four."""
    g = np.random.default_rng(SEED + 3)
    wide = knn_inputs(torch, dev, scan_pts, scan_valid, 4096, 1024, 0.0, 11)
    pts = g.normal(size=(1, 3000, 3)).astype(np.float32)
    pts[:, 1500:] = pts[:, :1500]
    few_v = np.zeros((1, 3000), bool)
    few_v[0, g.permutation(3000)[:20]] = True
    t = lambda x: torch.from_numpy(x).to(dev)
    return [("k65", *wide, 65, 0.0), ("k128", *wide, 128, 0.0),
            ("ties", t(pts), t(np.ones((1, 3000), bool)), t(pts[:, :1001]),
             40, 0.3),
            ("few_valid", t(pts), t(few_v), t(pts[:, :1001]), 40, 0.3)]


# --------------------------------------------------------------- K3, K4
def ulp_err(a, ref) -> float:
    """max |a - ref| in units of ref's float32 ulp."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(ref), 1e-30))[1] - 24)
    return float(np.max(np.abs(a - ref) / ulp))


def check_moment_values(got, ref, name: str) -> float:
    """cnt equal, s and S6 within one float32 ulp (both versions sum exact
    float64 products and round once; the order of the float64 additions
    differs). Returns the largest absolute difference."""
    if not np.array_equal(got[0], ref[0]):
        raise AssertionError(f"{name} cnt differs from its plain version")
    worst = max(ulp_err(a, r) for a, r in zip(got[1:], ref[1:]))
    if worst > 1.0:
        raise AssertionError(f"{name} moments differ from the plain version "
                             f"by {worst} ulp")
    return max(float(np.max(np.abs(a.astype(np.float64) - r)))
               for a, r in zip(got, ref))


def sweep_flops(valid, in_radius: float) -> float:
    """8 FLOPs (|c|^2 - 2 c.p + |p|^2) for each pair of a center with a
    valid point of its scan: every one of the N rows is written, and an
    invalid point contributes to none. ~20 more for each pair inside the
    radius. Both from this run's inputs."""
    n = valid.shape[1]
    return 8.0 * n * float(valid.sum()) + 20.0 * in_radius


def check_moments(torch, sw, points, valid, radius):
    """One K3 shape against the plain version; returns its entry."""
    b, n, _ = points.shape
    got = [x.cpu().numpy() for x in sw.radius_moments_cuda(points, valid,
                                                           radius)]
    ref = [x.cpu().numpy() for x in sw.radius_moments_plain(points, valid,
                                                            radius)]
    err = check_moment_values(got, ref, "K3")
    ms = timed_ms(torch, lambda: sw.radius_moments_cuda(points, valid,
                                                        radius), 20)
    plain_ms = timed_ms(torch, lambda: sw.radius_moments_plain(
        points, valid, radius), 2)
    bound_ms, by = bound(b * n * 13 + b * n * 40,
                         sweep_flops(valid, float(got[0].sum())))
    return dict(name="moments", shape=list(sw.moments_shape(b, n, radius)),
                valid_points=int(valid.sum()), route="cuda",
                source=SOURCES["moments"],
                replaces=REPLACES["moments"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None)


def check_sweep(torch, sw, points, valid, k, radius):
    """One K4 shape against the plain version: indices and dist2 identical,
    moments as K3; returns its entry."""
    b, n, _ = points.shape
    got = [x.cpu().numpy() for x in sw.fused_sweep_cuda(points, valid, k,
                                                        radius)]
    ref = [x.cpu().numpy() for x in sw.fused_sweep_plain(points, valid, k,
                                                         radius)]
    if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
        raise AssertionError(f"K4 differs from its plain version at N={n} "
                             f"k={k}")
    if got[0].min() < 0 or got[0].max() >= n:
        raise AssertionError("K4 index out of range")
    err, in_radius = 0.0, 0.0
    if radius > 0:
        err = check_moment_values(got[2:], ref[2:], "K4")
        in_radius = float(got[2].sum())
    ms = timed_ms(torch, lambda: sw.fused_sweep_cuda(points, valid, k,
                                                     radius), 20)
    plain_ms = timed_ms(torch, lambda: sw.fused_sweep_plain(points, valid, k,
                                                            radius), 2)

    def library():
        d = torch.cdist(points, points)
        d = d.masked_fill(~valid[:, None, :], float("inf"))
        return torch.topk(d, min(k, n), dim=-1, largest=False)

    library_ms = timed_ms(torch, library, 10)
    nbytes = b * n * 13 + b * n * k * 12 + (b * n * 40 if radius > 0 else 0)
    bound_ms, by = bound(nbytes, sweep_flops(valid, in_radius))
    return dict(name="sweep", shape=list(sw.sweep_shape(b, n, k, radius)),
                valid_points=int(valid.sum()), route="cuda",
                source=SOURCES["sweep"],
                replaces=REPLACES["sweep"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=library_ms)


def sweep_recall(sw, nb, points, valid, k) -> float:
    """Share of K2's exact k nearest that K4 returns, over valid centers."""
    approx = sw.fused_sweep_cuda(points, valid, k)[0][valid].cpu().numpy()
    exact = nb.knn_cuda(points, points, k, valid)[0][valid].cpu().numpy()
    return float(np.mean([len(np.intersect1d(a, e)) / k
                          for a, e in zip(approx, exact)]))


def odd_scan(torch, dev):
    """A small odd shape: N not a multiple of 128, few valid points."""
    g = np.random.default_rng(SEED + 1)
    pts = (g.normal(size=(2, 1000, 3)) * 5.0).astype(np.float32)
    valid = np.zeros((2, 1000), bool)
    for i in range(2):
        valid[i, g.permutation(1000)[:37]] = True
    return torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)


def seam_scans(torch, dev, scan_pts, crop):
    """Inputs at the seams of K3's and K4's class-major layout, as (name,
    points, valid, radius, ks): the frame-0 scan with its points scattered
    over the 16384 slots (valid and invalid interleaved), a whole invalid
    stretch of two 128-point tiles and classes 5 and 77 cut to at most one
    valid point; and B = 2 ragged clouds (n = 5001) in which every point
    occurs twice (distance ties across classes), with the same cuts. ks:
    the K4 widths checked on it, k = 1, 17, 41 and 128 between them."""
    g = np.random.default_rng(SEED + 4)

    def cut(valid):
        n = valid.shape[-1]
        valid[..., n // 3:n // 3 + 256] = False
        cls = np.arange(n) % 128
        valid[..., (cls == 5) | (cls == 77)] = False
        valid[..., 5] = True
        return valid

    order = g.permutation(N_PAD)
    scattered = np.zeros((1, N_PAD, 3), np.float32)
    scattered_v = np.zeros((1, N_PAD), bool)
    scattered[0, order] = scan_pts
    scattered_v[0, order] = crop
    ties = (g.normal(size=(2, 5001, 3)) * 3.0).astype(np.float32)
    ties[:, 2500:] = ties[:, :2501]
    ties_v = g.random((2, 5001)) < 0.6
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return [("scattered", t(scattered), t(cut(scattered_v)), 0.5, (41, 128)),
            ("ragged_ties_b2", t(ties), t(cut(ties_v)), 1.0, (1, 17))]


def route_survivors(torch, normals, preprocess, cfgs, scan, scan_v, valid_raw):
    """The three routes of filter_sweep on frame 0 (K2 with its moments;
    K4; K3 + K2 without moments), at each given preprocess config: the
    sweep's time on the inputs preprocess gives it (the scan under the
    distance crop), and the number of filter survivors on which each route
    differs from the K2 route. Restores the switches."""
    routes = {"k2": (False, False), "k4": (True, False),
              "k3_k2": (False, True)}
    out = {}
    try:
        for width, cfg in cfgs.items():
            k = max(cfg.normals_num + 1, cfg.outlier_neighbors + 1,
                    cfg.sweep_k)
            base, row = None, {}
            for name, (fused_sweep, fused_moments) in routes.items():
                normals.USE_FUSED_SWEEP = fused_sweep
                normals.USE_FUSED_MOMENTS = fused_moments
                ms = timed_ms(torch, lambda: normals.filter_sweep(
                    scan, scan_v, k, cfg.normals_radius), 10)
                kept = preprocess(scan, valid_raw, cfg)[1].cpu().numpy()
                base = kept if base is None else base
                row[name] = dict(sweep_ms=ms, survivors=int(kept.sum()),
                                 differ_from_k2=int((kept != base).sum()))
            out[width] = dict(k=k, **row)
    finally:
        normals.USE_FUSED_SWEEP = normals.USE_FUSED_MOMENTS = False
    return out


def drive_main_path(engine, pts, valid, poses) -> dict:
    """extract on frame 0, odometry_step frame to frame, register_with_info
    (frame 0 -> 2) and loop_scores (each frame against the next), through
    the engine's public entry points; checks the outputs' ranges."""
    frames = []
    t0 = time.perf_counter()
    d, dv, pv = engine.extract(pts[:1], valid[:1])
    extract_ms = (time.perf_counter() - t0) * 1e3
    frames.append((d, dv, pv, None))
    frame_ms, pose_err = [], []
    for i in range(1, len(pts)):
        pd, pdv, ppv, _ = frames[-1]
        t0 = time.perf_counter()
        out = engine.odometry_step(pts[i:i + 1], valid[i:i + 1], pd[0],
                                   pdv[0], pts[i - 1], ppv[0])
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        frames.append((out[0], out[1], out[2], out[3:]))
        gt = np.linalg.inv(poses[i]) @ poses[i - 1]    # new = gt @ cand
        pose_err.append(dict(
            frame=i, rot_deg=rotation_deg(out[3][:3, :3], gt[:3, :3]),
            trans_m=float(np.linalg.norm(out[3][:3, 3] - gt[:3, 3])),
            conf=out[4], rmse=out[5]))
    f0, f2 = frames[0], frames[2]
    reg = engine.register_with_info(f0[0][0], f0[1][0], f2[0][0], f2[1][0],
                                    pts[0], f0[2][0], pts[2], f2[2][0])
    descs = np.concatenate([f[0] for f in frames])
    dvs = np.concatenate([f[1] for f in frames])
    loop = engine.loop_scores(descs[:-1], descs[1:], dvs[:-1], dvs[1:])

    infos = [f[3][3] for f in frames[1:]] + [reg[3]]
    confs = [f[3][1] for f in frames[1:]] + [reg[1]]
    finite = bool(np.isfinite(descs).all()) and all(
        np.isfinite(i).all() for i in infos)
    asym = max(relerr(i, i.T) for i in infos)
    if not finite or not all(0.0 <= c <= 1.0 for c in confs) or asym > 1e-6:
        raise AssertionError(f"main path output out of range: finite="
                             f"{finite} conf={confs} info asym={asym}")
    width = engine.args.encoder.out_channel + 3
    if descs.shape[1:] != (engine.n_tokens, width) or not (
            np.isfinite(loop).all() and ((loop >= 0) & (loop <= 1)).all()):
        raise AssertionError(f"bad shapes or loop scores: {descs.shape} "
                             f"{loop}")
    later = frame_ms[1:] or frame_ms
    return dict(frames=frames, summary=dict(
        frames=len(pts), extract_first_ms=extract_ms,
        frame_ms_median=float(np.median(later)), frame_ms=frame_ms,
        scans_per_s=1e3 / float(np.median(later)), pose_err=pose_err,
        register_conf=reg[1], loop_scores=[float(p) for p in loop],
        survivors=[int(f[2].sum()) for f in frames],
        valid_points=[int(v.sum()) for v in valid]))


# ----------------------------------------------------------------- SLAM
#: the engine entry points the SLAM host layer can reach
ENTRY_POINTS = ("extract", "odometry_step_async", "register",
                "register_with_info_async", "register_with_info_multi_async",
                "register_scan_to_map_with_info_async",
                "register_map_to_map_with_info_async", "loop_scores_by_token",
                "invalidate_device_cache")


def count_calls(engine) -> dict:
    """Wrap the engine's entry points so that each call is counted."""
    calls = dict.fromkeys(ENTRY_POINTS, 0)
    for name in ENTRY_POINTS:
        def wrapped(*a, _fn=getattr(engine, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(engine, name, wrapped)
    return calls


def run_slam(infer, args, engine, seq_dir: str, out_dir: str):
    """pipeline.infer.run_sequence (what the CLI's main calls for each
    sequence), recording every step's exit code and the pose of the newest
    frame in the graph right after it. -> (system, log, seconds)."""
    log = []
    step = infer.SlamSystem.step

    def recorded(self, data):
        code = step(self, data)
        pg = self.posegraph_map
        log.append((code.name, pg.get_scanpack(
            pg.last_known_anyframe).SE3_pred.copy()))
        return code

    infer.SlamSystem.step = recorded
    try:
        t0 = time.perf_counter()
        system = infer.run_sequence(args, engine, seq_dir, out_dir)
        seconds = time.perf_counter() - t0
    finally:
        infer.SlamSystem.step = step
    return system, log, seconds


def slam_summary(system, codes, seconds, out_dir, poses,
                 max_drop_share=0.25) -> dict:
    """Checks the result tree of a run (`codes`: every frame's exit code)
    and summarizes it. Raises if a file is missing, a pose is not finite,
    the rows do not match the accepted frames, or more than
    `max_drop_share` of the frames were dropped (None: no such gate). The
    ATE is taken over every accepted frame against the ground truth
    relative to frame 0: unaligned (`ate_m`) and after the Umeyama
    alignment of utils/evaluation (`ate_aligned_m`, the JAX package's
    accuracy metric); neither is gated."""
    from deeppointmap_tpu_torch.utils import evaluation

    n = len(codes)
    files = [f"trajectory.{k}.txt" for k in ("allframes", "allsteps",
                                             "keyframes", "keysteps")]
    for name in files + ["trajectory.pg.g2o"]:
        if not os.path.exists(os.path.join(out_dir, name)):
            raise AssertionError(f"{name} was not written")
    rows = np.loadtxt(os.path.join(out_dir, files[0]), ndmin=2)
    steps = np.loadtxt(os.path.join(out_dir, files[1]), ndmin=1).astype(int)
    dropped = codes.count("drop")
    if rows.shape != (n - dropped, 12) or not np.isfinite(rows).all():
        raise AssertionError(f"trajectory rows {rows.shape} for {n} frames, "
                             f"{dropped} dropped")
    if max_drop_share is not None and dropped > n * max_drop_share:
        raise AssertionError(f"{dropped} of {n} frames were dropped")
    pg = system.posegraph_map
    gt = np.stack([np.linalg.inv(poses[0]) @ poses[i] for i in steps])
    pred = np.tile(np.eye(4), (len(rows), 1, 1))
    pred[:, :3, :] = rows.reshape(-1, 3, 4)
    rl = system.result_logger
    odom = [e for e in pg.get_all_edges() if e.type in ("odom", "locz")]
    return dict(
        frames=n, seconds=seconds, scans_per_s=n / seconds,
        stage_ms_median={k: float(np.median(rl.get_time_list(k))) * 1e3
                         for k in rl.time_recorder},
        codes={c: codes.count(c) for c in sorted(set(codes))},
        dropped=dropped, keyframes=int(pg.key_frame_num),
        loop_edges=sum(e.type == "loop" for e in pg.get_all_edges()),
        edge_conf_median=float(np.median([e.confidence for e in odom])),
        edge_rmse_median=float(np.median([e.rmse for e in odom])),
        loop_stats=system.loop.stats,
        ate_m=evaluation.ate_rmse(pred, gt, align=False),
        ate_aligned_m=evaluation.ate_rmse(pred, gt, align=True))


def run_slam_mt(infer, kernels, args, engine, seq_dir: str, out_dir: str):
    """pipeline.infer.run_sequence in the pipelined mode. Every mapping
    outcome is recorded (a keyframe's refined edge counts as "acpt"), and
    so are the launches of the warm-up that run_sequence runs first.
    -> (system, exit codes of all frames, seconds after the warm-up,
    {(kernel, shape): warm-up launches})."""
    from deeppointmap_tpu_torch.slam.modules import MappingModule
    from deeppointmap_tpu_torch.slam.utils import EXIT_CODE

    codes, warm, warm_s = [], collections.Counter(), []
    process, warmup = MappingModule.process, infer.SlamSystem.warmup

    def recorded(self, new_scan, odom_edge):
        out = process(self, new_scan, odom_edge)
        codes.append(out.name if isinstance(out, EXIT_CODE) else "acpt")
        return out

    def counted_warmup(self, example):
        t0 = time.perf_counter()
        before = {(k.name, sh): c for k in kernels.ALL
                  for sh, c in k.shapes.items()}
        warmup(self, example)
        for k in kernels.ALL:
            for sh, c in k.shapes.items():
                warm[(k.name, sh)] += c - before.get((k.name, sh), 0)
        warm_s.append(time.perf_counter() - t0)

    MappingModule.process = recorded
    infer.SlamSystem.warmup = counted_warmup
    try:
        t0 = time.perf_counter()
        system = infer.run_sequence(args, engine, seq_dir, out_dir)
        seconds = time.perf_counter() - t0 - sum(warm_s)
    finally:
        MappingModule.process = process
        infer.SlamSystem.warmup = warmup
    n = len(os.listdir(seq_dir))
    if system._mapped_count != len(codes) or len(codes) != n - 1:
        raise AssertionError(f"pipelined run lost frames: {len(codes)} "
                             f"mapped of {n}")
    return system, ["acpt"] + codes, seconds, warm


@contextlib.contextmanager
def sync_counter(torch):
    """Counts, by thread name, the operations that synchronise with the
    GPU (torch.cuda.set_sync_debug_mode("warn") reports each as a warning
    in the thread that called it)."""
    counts = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            counts[threading.current_thread().name] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counts
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def host_seconds():
    """Host seconds spent in the multi-agent path's main calls, by call and
    by side ('agents': the agent systems' threads, summed over them;
    'cloud'): AgentSystem.step, CloudSystem.cloud_step, loop closure and
    the pose-graph optimization inside either. Yields {call@side: [seconds,
    calls]}."""
    from deeppointmap_tpu_torch.slam.modules import LoopClosureModule
    from deeppointmap_tpu_torch.slam.pose_graph import PoseGraph
    from deeppointmap_tpu_torch.slam.system import AgentSystem, CloudSystem

    totals = collections.defaultdict(lambda: [0.0, 0])
    lock = threading.Lock()
    targets = [(AgentSystem, "step", lambda o: o.system_id),
               (CloudSystem, "cloud_step", lambda o: o.system_id),
               (LoopClosureModule, "process",
                lambda o: o.posegraph_map.agent_id),
               (PoseGraph, "optim", lambda o: o.agent_id)]
    # (class, name, what the class itself defines: None for inherited)
    saved = [(cls, name, cls.__dict__.get(name)) for cls, name, _ in targets]

    def wrap(fn, name, side_of):
        def timed_call(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                key = f"{name}@{'cloud' if side_of(self) == 0 else 'agents'}"
                with lock:
                    totals[key][0] += time.perf_counter() - t0
                    totals[key][1] += 1
        return timed_call

    for cls, name, side_of in targets:
        setattr(cls, name, wrap(getattr(cls, name), name, side_of))
    try:
        yield totals
    finally:
        for cls, name, fn in saved:
            if fn is None:
                delattr(cls, name)
            else:
                setattr(cls, name, fn)


def trajectory_diff(out_a: str, out_b: str) -> float:
    """Largest difference between two result trees' trajectory files."""
    worst = 0.0
    for seq in sorted(os.listdir(out_a)):
        if not seq.startswith("Seq"):
            continue
        for name in ("allframes", "allsteps", "keyframes", "keysteps"):
            a = np.loadtxt(os.path.join(out_a, seq, f"trajectory.{name}.txt"),
                           ndmin=1)
            b = np.loadtxt(os.path.join(out_b, seq, f"trajectory.{name}.txt"),
                           ndmin=1)
            if a.shape != b.shape or a.size == 0:
                raise AssertionError(f"{seq} {name}: {a.shape} vs {b.shape}")
            worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def drive_unreached(engine, system, calls, infer, args, first_file) -> list:
    """Drive, on the stored keyframes of a finished run, every engine entry
    point the run did not reach, and the lazy odometry resolver (which only
    a pipelined caller uses); checks the outputs' ranges. -> names driven."""
    from deeppointmap_tpu_torch.data.readers import read_auto
    from deeppointmap_tpu_torch.slam.modules import (_member_tuples,
                                                     map_members)

    pg = system.posegraph_map
    kfs = sorted((s for s in pg.get_all_scans() if s.type == "full"),
                 key=lambda s: s.timestep)
    a, b, c = kfs[0], kfs[1], kfs[len(kfs) // 2]
    driven = []

    def check(out):
        SE3, conf, rmse, info = out
        if not (np.isfinite(SE3).all() and np.isfinite(info).all()
                and 0.0 <= conf <= 1.0 and np.isfinite(rmse)):
            raise AssertionError(f"engine result out of range: {conf} {rmse}")

    def unreached(name):
        if calls[name]:
            return False
        driven.append(name)
        return True

    if unreached("register"):
        SE3, conf, rmse = engine.register(a.key_points, a.key_valid,
                                          b.key_points, b.key_valid)
        check((SE3, conf, rmse, np.zeros(1)))
    if unreached("register_with_info_async"):
        check(engine.register_with_info(
            a.key_points, a.key_valid, b.key_points, b.key_valid, a.full_pcd,
            a.full_valid, b.full_pcd, b.full_valid, src_token=a.token,
            dst_token=b.token))
    if unreached("register_with_info_multi_async"):
        for res in engine.register_with_info_multi_async(
                [(x.key_points_ref(), x.key_valid, x.full_pcd,
                  x.full_valid_ref(), x.token) for x in (a, b)],
                c.key_points, c.key_valid, c.full_pcd, c.full_valid,
                dst_token=c.token):
            check(res())
    if unreached("register_scan_to_map_with_info_async"):
        check(engine.register_scan_to_map_with_info_async(
            _member_tuples(map_members(pg, a, a.coor_sys,
                                       exclude=(b.token,))), a.SE3_pred,
            b.key_points_ref(), b.key_valid, a.full_pcd, a.full_valid_ref(),
            b.full_pcd, b.full_valid_ref(), src_token=a.token,
            dst_token=b.token)())
    if unreached("register_map_to_map_with_info_async"):
        check(engine.register_map_to_map_with_info_async(
            _member_tuples(map_members(pg, a, a.coor_sys)), a.SE3_pred,
            _member_tuples(map_members(pg, c, c.coor_sys)), c.SE3_pred,
            a.full_pcd, a.full_valid_ref(), c.full_pcd, c.full_valid_ref(),
            src_token=a.token, dst_token=c.token)())
    if unreached("loop_scores_by_token"):
        probs = engine.loop_scores_by_token(
            [(x.token, x.key_points_ref(), x.key_valid) for x in kfs[:5]],
            c.key_points_ref(), c.key_valid, new_token=c.token)
        if probs.shape != (len(kfs[:5]),) or not (
                np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()):
            raise AssertionError(f"bad loop scores {probs}")
    # the lazy resolver: candidate from the cache by token, the new scan's
    # tensors cached under a token of its own and copied out on demand
    pts, _, _, valid, _ = infer.make_infer_transform(args)(read_auto(
        first_file))
    out = engine.odometry_step_async(
        pts, valid, lambda: 1 / 0, a.key_valid, lambda: 1 / 0, lambda: 1 / 0,
        cand_token=a.token, new_token=-1)()
    desc = out[0]()
    if desc.shape != (engine.n_tokens, engine.args.encoder.out_channel + 3) \
            or not np.isfinite(desc).all() or out[2]().shape != (N_PAD,):
        raise AssertionError("lazy odometry resolver gave bad arrays")
    check(out[3:])
    engine.invalidate_device_cache(-1)
    driven.append("odometry_step_async(new_token)")
    return driven


def normals_share(torch, nb, nm, sw, pts, valid, radius) -> dict:
    """Share of the valid points (with more than two neighbours) whose
    normal agrees, at |cos| >= 1 - 1e-4, with a float64 PCA of the same
    neighbourhood: from K2's moments and from K3's (both float64 sums
    rounded to float32 once)."""
    p64 = pts.double()
    feats = nb._p_feats(p64)
    ref = []
    for c0 in range(0, pts.shape[1], 1024):
        d = nb.pairwise_dist2(p64[:, c0:c0 + 1024], p64)
        w = (d <= radius * radius) & valid[:, None, :]
        ref.append(w.double() @ feats)
    ref = torch.cat(ref, dim=1)
    n_ref = nm.normals_from_moments(pts, ref[..., 0].clamp(min=1.0),
                                    ref[..., 1:4], ref[..., 4:10])
    keep = valid & (ref[..., 0] > 2)
    out = {}
    for name, mom in (("k2", nb.knn_cuda(pts, pts, 1, valid, radius)[2:]),
                      ("k3", sw.radius_moments_cuda(pts, valid, radius))):
        cos = (nm.normals_from_moments(pts, *mom) * n_ref).sum(-1).abs()
        out[name] = float((cos[keep] >= 1 - 1e-4).float().mean())
    return out


def launches_of(kernels, entries, path: str, launched: dict) -> dict:
    """Read every kernel's launches by shape after a path, fail if one ran
    at a shape that was not checked against its plain version, and add them
    to `launched[(kernel, shape)][path]`. -> {kernel: launches}."""
    checked = {(en["name"], tuple(en["shape"])) for en in entries}
    totals = {}
    for k in kernels.ALL:
        missing = [sh for sh in k.shapes if (k.name, sh) not in checked]
        if missing:
            raise AssertionError(f"{k.name} ran at unchecked shapes "
                                 f"{missing} in {path}")
        for sh, count in k.shapes.items():
            launched.setdefault((k.name, sh), {})[path] = count
        totals[k.name] = k.launches
    return totals


def require(launches: dict, names, path: str) -> None:
    """Fail unless every kernel in `names` launched in `path`."""
    idle = [name for name in names if launches.get(name, 0) <= 0]
    if idle:
        raise AssertionError(f"{path}: {idle} never launched: {launches}")


def compare_cpu(cpu, pts, valid, frames) -> list:
    """Frames 0 .. CPU_FRAMES-1 through `cpu` on the inputs the GPU run
    was given; raises unless rotation <= 0.05 deg, translation <= 1 cm,
    descriptor relerr <= 1e-3 and info relerr <= 1e-2 (near-tie 1-NN
    correspondences and the summation order)."""
    out0 = cpu.extract(pts[:1], valid[:1])
    cmp = [dict(frame=0, desc_relerr=relerr(out0[0], frames[0][0]),
                survivors_diff=int(np.sum(out0[2] != frames[0][2])))]
    for i in range(1, CPU_FRAMES):
        pd, pdv, ppv, _ = frames[i - 1]
        out = cpu.odometry_step(pts[i:i + 1], valid[i:i + 1], pd[0], pdv[0],
                                pts[i - 1], ppv[0])
        g = frames[i]
        cmp.append(dict(
            frame=i, desc_relerr=relerr(out[0], g[0]),
            survivors_diff=int(np.sum(out[2] != g[2])),
            rot_deg=rotation_deg(out[3][:3, :3], g[3][0][:3, :3]),
            trans_m=float(np.linalg.norm(out[3][:3, 3] - g[3][0][:3, 3])),
            info_relerr=relerr(out[6], g[3][3])))
    for c in cmp:
        if c["desc_relerr"] > 1e-3 or c.get("rot_deg", 0) > 0.05 or \
                c.get("trans_m", 0) > 0.01 or c.get("info_relerr", 0) > 1e-2:
            raise AssertionError(f"GPU and CPU disagree: {c}")
    return cmp


def compare_slam_cpu(cpu_log, gpu_log) -> list:
    """The first frames of slam_a through a CPU SlamSystem (K4's plain
    version) against the GPU run: same exit codes, poses within rotation
    <= 0.05 deg and translation <= 1 cm."""
    out = []
    for i, ((c_code, c_pose), (g_code, g_pose)) in enumerate(zip(cpu_log,
                                                                 gpu_log)):
        out.append(dict(frame=i, code=c_code, code_gpu=g_code,
                        rot_deg=rotation_deg(c_pose[:3, :3], g_pose[:3, :3]),
                        trans_m=float(np.linalg.norm(c_pose[:3, 3]
                                                     - g_pose[:3, 3]))))
        if c_code != g_code or out[-1]["rot_deg"] > 0.05 \
                or out[-1]["trans_m"] > 0.01:
            raise AssertionError(f"GPU and CPU SLAM disagree: {out[-1]}")
    return out


def main(out_dir: str = "") -> int:
    """Run every phase; with `out_dir`, also write the kernel entries
    there as chip_smoke.json and every emitted line to chip_smoke.log."""
    import torch

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        EMIT_COPY.append(os.path.join(out_dir, "chip_smoke.log"))
        open(EMIT_COPY[-1], "w").close()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from deeppointmap_tpu_torch import kernels
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.data.preprocess import (PreprocessConfig,
                                                        preprocess)
    from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices
    from deeppointmap_tpu_torch.data.readers import read_auto
    from deeppointmap_tpu_torch.models import decoder as decoder_mod
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.ops import neighbors, normals, sampling, sweep
    from deeppointmap_tpu_torch.pipeline import infer
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    # full f32 everywhere: TF32 would round distances at +-60 m
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = dict(name=torch.cuda.get_device_name(0), nvidia_smi=smi,
                count=torch.cuda.device_count())
    emit(dict(phase="device", torch=torch.__version__,
              cuda=torch.version.cuda, **card))

    t0 = time.perf_counter()
    kernels.build_all()
    ptxas = "\n".join(k.build_log for k in kernels.ALL)
    emit(dict(phase="build", seconds=time.perf_counter() - t0, card=smi,
              max_registers=max(map(int, re.findall(r"Used (\d+) registers",
                                                     ptxas)), default=None),
              max_spill_store_bytes=max(map(int, re.findall(
                  r"(\d+) bytes spill stores", ptxas)), default=None)))

    sample_gates = {k: CONFIG["slam_system"][k] for k in SYNTHETIC_GATES}
    CONFIG["slam_system"].update(SYNTHETIC_GATES)
    args = config_from_dict(CONFIG, multi_thread=False)
    # the first SLAM_A_FRAMES of the JAX package's two-lap accuracy world
    raw = render_raw(syn, ACC_FRAMES)
    pts, valid, poses = render_scans(syn, voxel_downsample_indices, raw)
    pre = PreprocessConfig.from_transforms(args.transforms)

    # ---------------------------------------------------------- K1, K2
    entries = []
    npoint = args.encoder.npoint
    x = torch.from_numpy(pts[:1] / 60.0).float().to(dev)
    v = torch.from_numpy(valid[:1]).to(dev)
    n_in = [N_PAD] + list(npoint[:-1])
    for n, k in zip(n_in, npoint):
        xs = x[:, :n].contiguous() if n == N_PAD else \
            torch.randn(1, n, 3, device=dev) * 0.3
        vs = v if n == N_PAD else torch.ones(1, n, dtype=torch.bool,
                                             device=dev)
        entries.append(check_fps(torch, sampling, xs, vs, k))
    x4 = torch.from_numpy(pts[:WARMUP_BATCH] / 60.0).float().to(dev)
    v4 = torch.from_numpy(valid[:WARMUP_BATCH]).to(dev)
    entries.append(check_fps(torch, sampling, x4, v4, npoint[0]))
    for n, k in list(zip(n_in, npoint))[1:]:
        entries.append(check_fps(
            torch, sampling, torch.randn(WARMUP_BATCH, n, 3, device=dev) * 0.3,
            torch.ones(WARMUP_BATCH, n, dtype=torch.bool, device=dev), k))
    odd = {name: check_fps(torch, sampling, xs, vs, k)["ms"]
           for name, xs, vs, k in odd_fps_cases(torch, dev)}
    emit(dict(phase="k1", card=smi, odd_cases_ms=odd, shapes=[
        {key: e[key] for key in ("shape", "max_abs_err", "ms", "host_us",
                                 "plain_ms")} for e in entries]))

    # every K2 shape of the paths (models/encoder.py, data/preprocess.py,
    # ops/infomat.py at this config); the sweep without moments is slam_b's
    e, n_lv = args.encoder, len(npoint)
    k_sweep = pre.normals_num + 1
    k_reuse = int(e.nsample_list[0][0]) + 9
    knn_shapes = [(N_PAD, N_PAD, k_sweep, pre.normals_radius),
                  (N_PAD, N_PAD, k_sweep, 0.0),
                  # what `tpu.sweep_reuse` alone runs (no path here does)
                  (N_PAD, N_PAD, k_reuse, pre.normals_radius),
                  (N_PAD, npoint[0], e.nsample_list[0][0], 0.0)]
    for i in range(n_lv):
        own = max(e.nsample_list[i][1:], default=0)
        nxt = e.nsample_list[i + 1][0] if i + 1 < n_lv else 0
        knn_shapes.append((npoint[i], npoint[i], max(own, nxt), 0.0))
    for i in range(e.upsample_layers):
        knn_shapes.append((npoint[n_lv - 1 - i], npoint[n_lv - 2 - i], 3,
                           0.0))
    # the warm-up's batch of four runs the level graphs and FP at B = 4
    batched = [(WARMUP_BATCH, *sh) for sh in knn_shapes[4:]]
    stride = int(args.tpu.infomat_stride)
    knn_shapes.append((N_PAD, -(-N_PAD // stride), 1, 0.0))
    # configs/infer/ma_synthetic.yaml takes the info matrix at stride 1
    knn_shapes.append((N_PAD, N_PAD, 1, 0.0))
    # the knn querier (phase encoder_options) queries each SA's centers
    for i in range(1, n_lv):
        knn_shapes.append((npoint[i - 1], npoint[i], e.nsample_list[i][0],
                           0.0))
    k2 = []
    for j, (b, n, s, k, radius) in enumerate(
            [(1, *sh) for sh in knn_shapes] + batched):
        parts = [knn_inputs(torch, dev, pts[i], valid[i], n, s, radius,
                            100 * j + i) for i in range(b)]
        inputs = [torch.cat(x) for x in zip(*parts)]
        k2.append(check_knn(torch, neighbors, inputs[0], inputs[1],
                            inputs[2], k, radius))
    odd = {name: check_knn(torch, neighbors, p, v, c, k, radius)["ms"]
           for name, p, v, c, k, radius in odd_knn_cases(torch, dev, pts[0],
                                                         valid[0])}
    emit(dict(phase="k2", card=smi, odd_cases_ms=odd, shapes=[
        {key: e[key] for key in ("shape", "max_abs_err", "ms", "host_us",
                                 "plain_ms", "library_ms")} for e in k2]))
    entries += k2

    # ---------------------------------------------------------- K3, K4
    # the preprocessing sweep's inputs: a scan in raw meters under the
    # validity that the distance crop leaves
    dist = np.linalg.norm(pts[0], axis=1)
    crop = valid[0] & (dist >= pre.min_dis) & (dist <= pre.max_dis)
    scan = torch.from_numpy(pts[:1]).to(dev)
    scan_v = torch.from_numpy(crop[None]).to(dev)
    odd_p, odd_v = odd_scan(torch, dev)
    seams = seam_scans(torch, dev, pts[0], crop)
    k3 = [check_moments(torch, sweep, scan, scan_v, pre.normals_radius),
          check_moments(torch, sweep, odd_p, odd_v, 2.0)]
    odd = {name: check_moments(torch, sweep, p, v, radius)["ms"]
           for name, p, v, radius, _ in seams}
    emit(dict(phase="k3", card=smi, seam_cases_ms=odd, shapes=[
        {key: en[key] for key in ("shape", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms")} for en in k3]))
    pre_wide = PreprocessConfig.from_transforms(args.transforms,
                                                sweep_k=k_reuse)
    emit(dict(phase="k4_routes", card=smi, frame=0, routes=route_survivors(
        torch, normals, preprocess, {"filters": pre, "sweep_reuse": pre_wide},
        scan, scan_v, torch.from_numpy(valid[:1]).to(dev))))
    crop4 = valid[:WARMUP_BATCH] & (np.linalg.norm(
        pts[:WARMUP_BATCH], axis=2) >= pre.min_dis) & (np.linalg.norm(
            pts[:WARMUP_BATCH], axis=2) <= pre.max_dis)
    k4 = [check_sweep(torch, sweep, scan, scan_v, k_reuse,
                      pre.normals_radius),
          check_sweep(torch, sweep, odd_p, odd_v, k_reuse, 2.0),
          # the filters' own width (the K4 route without sweep reuse)
          check_sweep(torch, sweep, scan, scan_v, k_sweep,
                      pre.normals_radius),
          check_sweep(torch, sweep,
                      torch.from_numpy(pts[:WARMUP_BATCH]).to(dev),
                      torch.from_numpy(crop4).to(dev), k_reuse,
                      pre.normals_radius)]
    odd = {f"{name}_k{k}": check_sweep(torch, sweep, p, v, k,
                                       radius if k < 128 else 0.0)["ms"]
           for name, p, v, radius, ks in seams for k in ks}
    recall = {str(k): sweep_recall(sweep, neighbors, scan, scan_v, k)
              for k in (k_sweep, k_reuse)}
    # one membership rule and one way of summing: on the sweep's inputs cnt
    # is equal across K2, K3 and K4, and the sums agree within one ulp
    host = lambda xs: [x.cpu().numpy() for x in xs]
    m3 = host(sweep.radius_moments_cuda(scan, scan_v, pre.normals_radius))
    check_moment_values(host(neighbors.knn_cuda(
        scan, scan, k_sweep, scan_v, pre.normals_radius)[2:]), m3,
        "K2 against K3:")
    check_moment_values(host(sweep.fused_sweep_cuda(
        scan, scan_v, k_sweep, pre.normals_radius)[2:]), m3,
        "K4 against K3:")
    # the same scan through K2 at K4's width, for the comparison in PERF.md
    k2_wide_ms = timed_ms(torch, lambda: neighbors.knn_cuda(
        scan, scan, k_reuse, scan_v, pre.normals_radius), 5)
    # K4 at the filters' own width: its cost should not depend on k
    emit(dict(phase="k4", card=smi, recall_vs_k2=recall, seam_cases_ms=odd,
              k2_ms_at_k4_shape=k2_wide_ms,
              k4_ms_at_k={str(k_sweep): k4[2]["ms"],
                          str(k_reuse): k4[0]["ms"]}, shapes=[
        {key: en[key] for key in ("shape", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "library_ms")} for en in k4]))
    if min(recall.values()) < 0.97:
        raise AssertionError(f"K4 recall below 0.97: {recall}")
    entries += k3 + k4

    # -------------------------------------------------------- main path
    enc_sd, dec_sd = load_msgpack_weights(WEIGHTS)
    engine = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                             device="cuda")
    launched = {}
    kernels.reset_launches()
    main_out = drive_main_path(engine, pts, valid, poses)
    launches = launches_of(kernels, entries, "main", launched)
    if min(launches["fps"], launches["knn"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    emit(dict(phase="main", card=smi, **main_out["summary"],
              launches=launches))

    # ------------------------------------- SLAM through the CLI's path
    with tempfile.TemporaryDirectory() as tmp:
        seq_a, seq_b, seq_c, seq_d, seq_h = (os.path.join(tmp, d)
                                             for d in "abcdh")
        write_bins(raw[0][:SLAM_A_FRAMES], seq_a)
        write_bins(raw[0][:SLAM_B_FRAMES], seq_b)
        write_bins(raw[0][:CPU_FRAMES], seq_c)
        write_bins(raw[0][SLAM_B_FRAMES:2 * SLAM_B_FRAMES], seq_d)
        write_bins(raw[0][:HOST_FRAMES], seq_h)
        first_file = os.path.join(seq_a, "000001.bin")

        # slam_a: sweep reuse on, K4 for the filters and stage 1
        args_a = config_from_dict(CONFIG, multi_thread=False)
        args_a.tpu.sweep_reuse = True
        pre_a = infer.device_preprocess_config(args_a)
        engine_a = InferenceEngine(args_a, enc_sd, dec_sd,
                                   preprocess_cfg=pre_a, device="cuda")
        calls = count_calls(engine_a)
        normals.USE_FUSED_SWEEP = True
        kernels.reset_launches()
        system_a, log_a, sec_a = run_slam(infer, args_a, engine_a, seq_a,
                                          os.path.join(tmp, "out_a"))
        launches = launches_of(kernels, entries, "slam_a", launched)
        reached = dict(calls)
        k4_shape = sweep.sweep_shape(1, N_PAD, pre_a.sweep_k,
                                     pre_a.normals_radius)
        stage1 = neighbors.knn_shape(1, N_PAD, npoint[0],
                                     e.nsample_list[0][0], 0.0)
        if kernels.SWEEP.shapes[k4_shape] != SLAM_A_FRAMES \
                or kernels.KNN.shapes[stage1] != 0 \
                or min(launches["fps"], launches["knn"]) <= 0:
            raise AssertionError(f"slam_a launches: {launches} "
                                 f"{dict(kernels.SWEEP.shapes)}")
        summary_a = slam_summary(system_a, [c for c, _ in log_a], sec_a,
                                 os.path.join(tmp, "out_a"), raw[1])
        driven = drive_unreached(engine_a, system_a, calls, infer, args_a,
                                 first_file)
        emit(dict(phase="slam_a", card=smi, **summary_a, launches=launches,
                  engine_calls=reached, driven_directly=driven))

        # slam_b: sweep reuse off, K3 for the moments beside K2
        normals.USE_FUSED_SWEEP = False
        normals.USE_FUSED_MOMENTS = True
        kernels.reset_launches()
        system_b, log_b, sec_b = run_slam(infer, args, engine, seq_b,
                                          os.path.join(tmp, "out_b"))
        launches = launches_of(kernels, entries, "slam_b", launched)
        k3_shape = sweep.moments_shape(1, N_PAD, pre.normals_radius)
        k2_shape = neighbors.knn_shape(1, N_PAD, N_PAD, k_sweep, 0.0)
        if kernels.MOMENTS.shapes[k3_shape] != SLAM_B_FRAMES \
                or kernels.KNN.shapes[k2_shape] != SLAM_B_FRAMES \
                or launches["sweep"] != 0 or launches["fps"] <= 0:
            raise AssertionError(f"slam_b launches: {launches}")
        normals.USE_FUSED_MOMENTS = False
        summary_b = slam_summary(system_b, [c for c, _ in log_b], sec_b,
                                 os.path.join(tmp, "out_b"), raw[1])
        emit(dict(phase="slam_b", card=smi, **summary_b, launches=launches,
                  normals_match_f64_pca=normals_share(
                      torch, neighbors, normals, sweep, scan, scan_v,
                      pre.normals_radius)))

        # slam_mt: slam_a's configuration, pipelined
        args_mt = config_from_dict(CONFIG, multi_thread=True)
        args_mt.tpu.sweep_reuse = True
        args_mt.tpu.odometer_pipeline_depth = 1
        normals.USE_FUSED_SWEEP = True
        kernels.reset_launches()
        system_mt, codes_mt, sec_mt, warm = run_slam_mt(
            infer, kernels, args_mt, engine_a, seq_a,
            os.path.join(tmp, "out_mt"))
        launches = launches_of(kernels, entries, "slam_mt", launched)
        frames_k4 = kernels.SWEEP.shapes[k4_shape] - warm[("sweep",
                                                           k4_shape)]
        if frames_k4 != SLAM_A_FRAMES or kernels.KNN.shapes[stage1] != 0:
            raise AssertionError(f"slam_mt: K4 launched {frames_k4} times "
                                 f"for {SLAM_A_FRAMES} frames: {launches}")
        require(launches, ("fps", "knn", "sweep"), "slam_mt")
        summary_mt = slam_summary(system_mt, codes_mt, sec_mt,
                                  os.path.join(tmp, "out_mt"), raw[1])
        # the synchronisations a frame on the odometer thread
        kernels.reset_launches()
        with sync_counter(torch) as syncs:
            run_slam_mt(infer, kernels, args_mt, engine_a, seq_b,
                        os.path.join(tmp, "out_mt_sync"))
        launches_of(kernels, entries, "slam_mt_syncs", launched)
        normals.USE_FUSED_SWEEP = False
        emit(dict(phase="slam_mt", card=smi, **summary_mt,
                  scans_per_s_slam_a=summary_a["scans_per_s"],
                  staleness_events=system_mt._staleness_events,
                  launches=launches, k4_frame_launches=frames_k4,
                  warmup_launches={f"{k}{list(sh)}": c
                                   for (k, sh), c in warm.items() if c},
                  syncs_per_frame={name: c / SYNC_FRAMES
                                   for name, c in syncs.items()}))

        # slam_robust: the RANSAC solve under sample.yaml's own gates
        cfg_r = copy.deepcopy(CONFIG)
        cfg_r["slam_system"].update(sample_gates)
        args_r = config_from_dict(cfg_r, multi_thread=False)
        args_r.tpu.sweep_reuse = True
        args_r.tpu.robust_register = True
        engine_r = InferenceEngine(args_r, enc_sd, dec_sd,
                                   preprocess_cfg=pre_a, device="cuda")
        solve, calls_r = decoder_mod.ransac_kabsch, []

        def recorded_solve(*a, **kw):
            calls_r.append(a)
            return solve(*a, **kw)

        normals.USE_FUSED_SWEEP = True
        decoder_mod.ransac_kabsch = recorded_solve
        kernels.reset_launches()
        try:
            system_r, log_r, sec_r = run_slam(infer, args_r, engine_r, seq_a,
                                              os.path.join(tmp, "out_r"))
        finally:
            decoder_mod.ransac_kabsch = solve
        launches = launches_of(kernels, entries, "slam_robust", launched)
        require(launches, ("fps", "knn", "sweep"), "slam_robust")
        normals.USE_FUSED_SWEEP = False
        summary_r = slam_summary(system_r, [c for c, _ in log_r], sec_r,
                                 os.path.join(tmp, "out_r"), raw[1],
                                 max_drop_share=None)
        one = calls_r[0]
        ransac_ms = timed_ms(torch, lambda: solve(*one), 20)
        with sync_counter(torch) as syncs:
            solve(*one)
            torch.cuda.synchronize()
        # the same solve on the CPU (the gumbel noise and every log are
        # computed alike on both devices): the cpu phase's pose bounds
        got = [x.cpu().numpy() for x in solve(*one)]
        want = [x.numpy() for x in solve(*(x.cpu() for x in one))]
        ransac_cpu = dict(
            rot_deg=rotation_deg(got[0], want[0]),
            trans_m=float(np.linalg.norm(got[1] - want[1])),
            inliers=int(want[2].sum()),
            inliers_differ=int((got[2] != want[2]).sum()),
            rmse_relerr=relerr(got[3], want[3]))
        if ransac_cpu["rot_deg"] > 0.05 or ransac_cpu["trans_m"] > 0.01:
            raise AssertionError(f"ransac_kabsch: GPU and CPU disagree: "
                                 f"{ransac_cpu}")
        # the gates the JAX package pairs with the RANSAC solve
        cfg_m = copy.deepcopy(cfg_r)
        cfg_m["slam_system"].update(RANSAC_GATES)
        args_m = config_from_dict(cfg_m, multi_thread=False)
        args_m.tpu.sweep_reuse = True
        args_m.tpu.robust_register = True
        normals.USE_FUSED_SWEEP = True
        kernels.reset_launches()
        system_m, log_m, sec_m = run_slam(infer, args_m, engine_r, seq_a,
                                          os.path.join(tmp, "out_m"))
        launches_m = launches_of(kernels, entries, "slam_robust_ransac_gates",
                                 launched)
        normals.USE_FUSED_SWEEP = False
        summary_m = slam_summary(system_m, [c for c, _ in log_m], sec_m,
                                 os.path.join(tmp, "out_m"), raw[1],
                                 max_drop_share=None)
        emit(dict(phase="slam_robust", card=smi, **summary_r,
                  ate_m_slam_a=summary_a["ate_m"], gates=sample_gates,
                  ransac_calls=len(calls_r), ransac_pairs=int(one[0].shape[0]),
                  ransac_ms=ransac_ms,
                  ransac_syncs=syncs[threading.current_thread().name],
                  ransac_gpu_vs_cpu=ransac_cpu, launches=launches,
                  with_ransac_gates=dict(
                      gates=RANSAC_GATES, launches=launches_m,
                      **{k: summary_m[k] for k in (
                          "ate_m", "ate_aligned_m", "codes", "keyframes",
                          "loop_edges", "scans_per_s", "edge_conf_median",
                          "edge_rmse_median")})))

        # sequence_parallel: two sequences through run_inference
        outs = {}
        kernels.reset_launches()
        for sp in (1, 2):
            outs[sp] = os.path.join(tmp, f"out_sp{sp}")
            args_sp = config_from_dict(
                CONFIG, multi_thread=False, device="cuda", weight=WEIGHTS,
                infer_src=[seq_b, seq_d], infer_tgt=outs[sp], profile=False)
            args_sp.tpu.sequence_parallel = sp
            engines_sp = infer.run_inference(args_sp)
        launches = launches_of(kernels, entries, "sequence_parallel",
                               launched)
        require(launches, ("fps", "knn"), "sequence_parallel")
        diff = trajectory_diff(outs[1], outs[2])
        if diff > 1e-5:
            raise AssertionError(f"sequence_parallel trajectories differ "
                                 f"from the sequential run's by {diff}")
        emit(dict(phase="sequence_parallel", card=smi, engines=engines_sp,
                  sequences=2, frames=2 * SLAM_B_FRAMES,
                  max_abs_diff=diff, launches=launches))

        # host_chain: the host transform chain, GPU against CPU
        args_h = config_from_dict(CONFIG, multi_thread=False)
        args_h.tpu.device_preprocess = False
        if infer.device_preprocess_config(args_h) is not None:
            raise AssertionError("host_chain: the device chain is on")
        gpu_h = InferenceEngine(args_h, enc_sd, dec_sd, preprocess_cfg=None,
                                device="cuda")
        kernels.reset_launches()
        system_h, log_h, sec_h = run_slam(infer, args_h, gpu_h, seq_h,
                                          os.path.join(tmp, "out_h"))
        launches = launches_of(kernels, entries, "host_chain", launched)
        require(launches, ("fps", "knn"), "host_chain")
        cpu_h = InferenceEngine(args_h, enc_sd, dec_sd, preprocess_cfg=None,
                                device="cpu")
        _, log_hc, _ = run_slam(infer, args_h, cpu_h, seq_h,
                                os.path.join(tmp, "out_hc"))
        host_cmp = compare_slam_cpu(log_hc, log_h)
        transform = infer.make_infer_transform(args_h)
        host_ms = []
        for i in range(HOST_FRAMES):
            scan_i = read_auto(os.path.join(seq_h, f"{i:06d}.bin"))
            t0 = time.perf_counter()
            transform(scan_i)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        emit(dict(phase="host_chain", card=smi,
                  **slam_summary(system_h, [c for c, _ in log_h], sec_h,
                                 os.path.join(tmp, "out_h"), raw[1]),
                  host_transform_ms_median=float(np.median(host_ms)),
                  cpu=host_cmp, launches=launches))

        # encoder_options: voxel sampler, knn and ball queriers
        options = {}
        for name, edit in (
                ("voxel", dict(sample=[{"type": "voxel", "size": 0.5 / 60,
                                        "range": 1.0}]
                               + [{"type": "fps"}] * (n_lv - 1))),
                ("knn", dict(querier="knn")), ("ball", dict(querier="ball"))):
            cfg_o = copy.deepcopy(CONFIG)
            cfg_o["encoder"].update(edit)
            args_o = config_from_dict(cfg_o, multi_thread=False)
            gpu_o = InferenceEngine(args_o, enc_sd, dec_sd,
                                    preprocess_cfg=pre, device="cuda")
            kernels.reset_launches()
            got = gpu_o.extract(pts[:1], valid[:1])
            launches = launches_of(kernels, entries, f"encoder_{name}",
                                   launched)
            require(launches, ("fps", "knn"), f"encoder_{name}")
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                gpu_o.extract(pts[:1], valid[:1])
                ms.append((time.perf_counter() - t0) * 1e3)
            want = InferenceEngine(args_o, enc_sd, dec_sd, preprocess_cfg=pre,
                                   device="cpu").extract(pts[:1], valid[:1])
            err = relerr(got[0], want[0])
            if err > 1e-3 or not np.array_equal(got[1], want[1]) \
                    or not np.isfinite(got[0]).all():
                raise AssertionError(f"encoder option {name}: GPU and CPU "
                                     f"disagree (desc relerr {err})")
            options[name] = dict(desc_relerr=err,
                                 extract_ms_median=float(np.median(ms)),
                                 tokens_valid=int(got[1].sum()),
                                 launches=launches)
        emit(dict(phase="encoder_options", card=smi, **options))

        # accuracy: the JAX package's accuracy block on the port
        gt = np.stack(raw[1])
        acc_dir = write_npz(raw[0], raw[1], os.path.join(tmp, "acc_world"))
        acc_cfg = dict(transforms=EVAL_TRANSFORMS, encoder=CONFIG["encoder"],
                       decoder=CONFIG["decoder"], loss=CONFIG["loss"],
                       slam_system=EVAL_SLAM, tpu=dict(robust_register=True))
        acc = {}
        kernels.reset_launches()
        for name, loops, chain in (
                ("loops_on", True, EVAL_TRANSFORMS),
                ("loops_off", False, EVAL_TRANSFORMS),
                ("sample_filter_chain", True, CONFIG["transforms"])):
            cfg_e = copy.deepcopy(acc_cfg)
            cfg_e["transforms"] = copy.deepcopy(chain)
            cfg_e["slam_system"].update(enable_loop_closure=loops,
                                        enable_global_optimization=loops)
            args_e = config_from_dict(cfg_e, multi_thread=False)
            engine_e = InferenceEngine(
                args_e, enc_sd, dec_sd, device="cuda",
                preprocess_cfg=infer.device_preprocess_config(args_e))
            out_e = os.path.join(tmp, f"out_acc_{name}")
            system_e, log_e, sec_e = run_slam(infer, args_e, engine_e,
                                              acc_dir, out_e)
            sm = slam_summary(system_e, [c for c, _ in log_e], sec_e, out_e,
                              raw[1], max_drop_share=None)
            acc[name] = dict(
                ate_aligned_m=sm["ate_aligned_m"], ate_unaligned_m=sm["ate_m"],
                frames_accepted=sm["frames"] - sm["dropped"],
                keyframes=sm["keyframes"], loop_edges=sm["loop_edges"],
                codes=sm["codes"], scans_per_s=sm["scans_per_s"],
                edge_conf_median=sm["edge_conf_median"],
                edge_rmse_median=sm["edge_rmse_median"])
        launches = launches_of(kernels, entries, "accuracy", launched)
        require(launches, ("fps", "knn"), "accuracy")
        emit(dict(phase="accuracy", card=smi, frames=ACC_FRAMES,
                  args="scripts/train_full_size.py full_eval_args",
                  ate_aligned_m=acc["loops_on"]["ate_aligned_m"],
                  ate_aligned_no_loop_m=acc["loops_off"]["ate_aligned_m"],
                  runs=acc, jax_tpu_reference=JAX_TPU_REFERENCE,
                  launches=launches))

        # ma_inproc: pipeline/infer_multiagents in process, 3 agents and
        # the cloud on one engine, on the same world
        import yaml

        from deeppointmap_tpu_torch.pipeline import infer_multiagents as ima
        from deeppointmap_tpu_torch.utils import evaluation

        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "infer", "ma_synthetic.yaml")) as f:
            ma_cfg = yaml.safe_load(f)

        def ma_run(seq, name, transport):
            """One run of infer_multiagents.main -> (cloud, its output
            directory, wall seconds, launches in this process)."""
            out = os.path.join(tmp, name)
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(dict(ma_cfg, infer_src=[seq], infer_tgt=out),
                               f)
            kernels.reset_launches()
            with host_seconds() as spent:
                t0 = time.perf_counter()
                cloud = ima.main(["--yaml_file", path, "--weight", WEIGHTS,
                                  "--transport", transport])
                wall = time.perf_counter() - t0
            return cloud, out, wall, launches_of(kernels, entries, name,
                                                 launched), dict(spent)

        def loop_edges(cloud):
            edges = [e for e in cloud.posegraph_map.get_all_edges()
                     if e.type == "loop"]
            return dict(loop_edges=len(edges), cross_agent_loop_edges=sum(
                (e.src_scan_token >> 16) != (e.dst_scan_token >> 16)
                for e in edges))

        def agent_frames(total):
            return sum(b - a for a, b in (split_range(total, MA_AGENTS, i)
                                          for i in range(MA_AGENTS)))

        cloud_ma, _, wall_ma, launches, spent = ma_run(
            acc_dir, "ma_inproc", "inproc")
        require(launches, ("fps", "knn"), "ma_inproc")
        emit(dict(phase="ma_inproc", card=smi, frames=ACC_FRAMES,
                  agents=MA_AGENTS, config="configs/infer/ma_synthetic.yaml",
                  **loop_edges(cloud_ma), loop_funnel=cloud_ma.loop.stats,
                  **ma_quality(evaluation, cloud_ma.posegraph_map, gt),
                  agent_frames=agent_frames(ACC_FRAMES),
                  frames_per_s=agent_frames(ACC_FRAMES) / wall_ma,
                  wall_s=wall_ma, host_seconds_calls=spent,
                  launches=launches, jax_tpu_reference=JAX_TPU_REFERENCE))

        # ma_tcp: three agent worker processes on the card, at a reduced
        # depth, against an in-process run over the same frames
        tcp_dir = write_npz(raw[0][:TCP_FRAMES], raw[1][:TCP_FRAMES],
                            os.path.join(tmp, "tcp_world"))
        tcp = {t: ma_run(tcp_dir, f"ma_{t}_{TCP_FRAMES}", t)
               for t in ("tcp", "inproc")}
        steps = {t: [np.loadtxt(os.path.join(
            tcp[t][1], f"agent_{i}", "trajectory.keysteps.txt"), ndmin=1)
            for i in range(1, MA_AGENTS + 1)] for t in tcp}
        same = all(np.array_equal(a, b)
                   for a, b in zip(steps["tcp"], steps["inproc"]))
        held = sorted({s.agent_id for s in
                       tcp["tcp"][0].posegraph_map.get_all_scans()})
        if held != list(range(1, MA_AGENTS + 1)) or not same:
            raise AssertionError(f"ma_tcp: the cloud holds agents {held}; "
                                 f"keyframes equal to in-process: {same}")
        emit(dict(phase="ma_tcp", card=smi, frames=TCP_FRAMES,
                  agents=MA_AGENTS, workers_exit_0=True, cloud_agents=held,
                  keyframes_per_agent=[len(x) for x in steps["tcp"]],
                  keyframes_equal_inproc=same,
                  cloud_vertices={t: tcp[t][0].posegraph_map.key_frame_num
                                  for t in tcp},
                  **{f"{t}_{k}": v for t in tcp
                     for k, v in loop_edges(tcp[t][0]).items()},
                  wall_s={t: tcp[t][2] for t in tcp},
                  frames_per_s={t: agent_frames(TCP_FRAMES) / tcp[t][2]
                                for t in tcp},
                  cloud_process_launches=tcp["tcp"][3],
                  host_seconds_calls={t: tcp[t][4] for t in tcp}))

        # viewer: the merged map of ma_inproc with normals on the card
        from deeppointmap_tpu_torch.utils.visualization import show_pcd

        merged = cloud_ma.result_logger.world_cloud()
        view = merged[voxel_downsample_indices(merged, 0.5,
                                               num=VIEWER_POINTS)]
        vt = torch.from_numpy(np.ascontiguousarray(view))[None].to(dev)
        vv = torch.ones(vt.shape[:2], dtype=torch.bool, device=dev)
        entries.append(check_knn(torch, neighbors, vt, vv, vt, 1, 1.0))
        kernels.reset_launches()
        t0 = time.perf_counter()
        html = show_pcd([view], window_name="merged map",
                        estimate_normals=True, open_browser=False,
                        out_html=os.path.join(tmp, "merged_map.html"),
                        device="cuda")
        view_s = time.perf_counter() - t0
        launches = launches_of(kernels, entries, "viewer", launched)
        require(launches, ("knn",), "viewer")
        with open(html) as f:
            data = json.loads(re.search(r"const DATA = (\[.*?\]);\n",
                                        f.read(), re.S).group(1))[0]
        nrm = np.frombuffer(base64.b64decode(data["normals"]),
                            np.float32).reshape(-1, 3)
        norms = np.linalg.norm(nrm, axis=1)
        if len(nrm) != len(view) or not np.allclose(norms, 1.0, atol=1e-3):
            raise AssertionError(f"viewer: {len(nrm)} normals for "
                                 f"{len(view)} points")
        emit(dict(phase="viewer", card=smi, merged_points=len(merged),
                  shown_points=len(view), html_bytes=os.path.getsize(html),
                  seconds=view_s, launches=launches))

        # ---------------------------------------------- CPU comparison
        cpu = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                              device="cpu")
        cpu_frames = compare_cpu(cpu, pts, valid, main_out["frames"])
        normals.USE_FUSED_SWEEP = True
        cpu_a = InferenceEngine(args_a, enc_sd, dec_sd, preprocess_cfg=pre_a,
                                device="cpu")
        _, log_c, _ = run_slam(infer, args_a, cpu_a, seq_c,
                               os.path.join(tmp, "out_c"))
        normals.USE_FUSED_SWEEP = False
    emit(dict(phase="cpu", card=smi, frames=cpu_frames,
              slam=compare_slam_cpu(log_c, log_a)))

    for en in entries:
        en["paths"] = launched.get((en["name"], tuple(en["shape"])), {})
        en["launches"] = sum(en["paths"].values())
    kernels_line = dict(kernels=[en for en in entries if en["launches"] > 0])
    if {en["name"] for en in kernels_line["kernels"]} != set(SOURCES):
        raise AssertionError("a kernel is missing from the kernels line")
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, entries=entries), f, indent=1)
    emit(kernels_line)
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=card["name"],
                                   count=card["count"])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ""))
