#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeppointmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [OUT_DIR]

Phases, in order, each printing one JSON line:
  device  the card (nvidia-smi name and power limit); fails without CUDA.
  build   nvcc builds the four kernels from csrc/, all at once.
  k1      K1 (FPS) against its plain version at the encoder's five stage
          shapes with B = 1, 2, 3 and 4 (B > 1: the warm-up's batch and the
          frames a training step encodes): identical indices; the
          demo-width model's four stages (2048 -> 512 -> 128 -> 64 -> 16,
          a real demo scan at the first) at B = 1, 4 and 6 (DEMO_BATCHES);
          also on duplicated points (ties), on a scan that does not fill
          the cluster's partition, and with fewer valid points than k.
  k2      K2 (kNN + radius moments) against its plain version at every
          shape a path gives it (the encoder's grouping, level graphs and FP
          3-NN also at the training steps' B = 2, 3, 4) and at the
          sweep-reuse width (k = 41 with
          moments), and the demo-width model's (encoder_knn_shapes at
          B = 1, 4, 6 with k 16 and 8, its information matrix's 1-NN):
          identical neighbour sets and dist2, cnt equal and
          moments within one float32 ulp; also at k = 65, 128 and 512
          (each timed with its bound and library time), on
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
          configs/infer/sample.yaml as shipped, `tpu.bf16` on: the
          network's products as cuBLAS calls with bfloat16 operands and a
          float32 output, utils/precision.py; trained weights from
          artifacts/full_size_occ_v2) on synthetic scans: extract, odometry
          frame to frame, register_with_info, loop_scores; the rule's
          products must have run (counted by precision.route_calls).
  main_f32  the same frames through an engine with `tpu.bf16: false`: no
          product may take the rule.
  sharded parallel/sharded_extract.extract_sequence (device preprocessing,
          the encoder, the descriptor concat) on 10 scans over one replica
          on cuda:0 and over two (the split and the tail padding on one
          card), at 1 and 4 scans a replica: held to engine.extract with
          upload_quant none (descriptors atol 2e-5, validity identical);
          then the replicas' build seconds, the host syncs of the built
          extractor's first call and its scans/s, with K1 / K2 launches by
          shape.
  slam_a  single-agent SLAM through pipeline.infer.run_sequence ->
          SlamSystem.step on 120 synthetic scans written as KITTI .bin
          files, with tpu.sweep_reuse and USE_FUSED_SWEEP: K4 serves the
          filters and the encoder's first stage (no K2 launch there). Engine
          entry points the run did not reach are then driven directly.
  native  the host voxel downsample (0.3 m, 'first') through the native
          library (deeppointmap_tpu_torch/native, g++ at first use) and
          through NumPy on slam_a's first raw scans and on a seeded
          122 880-point scan of the same world: identical indices, ms for
          each; slam_a must have taken the native route on every frame.
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
          transform chain) on the GPU and on the CPU, `tpu.bf16: false` (the
          chain is what is held here): the same exit codes, poses within
          0.05 deg and 1 cm; the host chain's ms a frame.
  encoder_options  one frame's extract with the voxel sampler, the knn
          querier and the ball querier, GPU against CPU, `tpu.bf16: false`:
          descriptors relerr <= 1e-3; their ms.
  precision  the `tpu.bf16` rule: every product shape main's frames gave
          the rule (recorded on frames 0-2), and attention over 256-4096
          tokens x 8 heads, through the cuBLAS route against its plain
          version on the same inputs (relerr <= 1e-5), with its ms beside
          the float32 torch.mm / bmm / addmm's (TF32 off); main's frames
          through an engine with `tpu.bf16: false` beside main's
          (descriptor relerr, pose differences, ms of extract, fused
          odometry and register + info); the accuracy world's ATE, loops
          on and off, under `tpu.bf16: false` beside the accuracy phase's
          (bfloat16) and the JAX package's TPU figures, labelled so.
  accuracy  the JAX package's accuracy block on the port: the two-lap world
          of scripts/train_full_size.py build_eval_world (192 frames, seed
          0, artifacts/full_size_occ_v2/render_meta.json) as an npz
          sequence, single-agent with the recipe's full_eval_args (no
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
  train   two-stage training at DeepPointMap-B full width: the scene of
          the full-size recipe's TRAIN_SCENES[0] (deeppointmap_tpu_torch/
          pipeline/full_size.py; 96 frames, ~16k points) rendered by
          data/synthetic.py, its full_train_args (K_0 3, one epoch a
          stage) run by `python -m
          deeppointmap_tpu_torch.pipeline.train` as a subprocess on the
          card, warm-started from the trained weights: seconds a step and
          the host's share by stage, peak device memory, loss / top1_acc /
          stage 2's acc, precision, recall first and last, K1 / K2 launches
          by shape a step (from its steps.jsonl). Gates: exit 0, finite
          losses, K1 and K2 launched at the training shapes (all checked in
          k1 / k2), the encoder and the non-loop heads bit for bit unchanged
          across stage 2, and weights_final.msgpack running 16 frames of the
          scene through pipeline/infer. Then stage 1 in process for a few
          steps with and without tpu.remat (seconds a step, peak memory,
          launches a step), and one stage-1 batch of two frames on the GPU
          against the CPU from the same weights: float32 on both sides,
          loss relerr <= 1e-4 and every gradient ||d|| / ||g|| <= 1e-3
          (TRAIN_F32_GATES); under the "bfloat16" rule on both sides (the
          CPU through its plain version), the loss relerr and the median
          gradient's within the float32 gate or SPREAD_FACTOR x the CPU's
          own spread under the rule (float64_sums, ulp_nudge), with the
          card's step again, the card's step with float64 sums and the
          rule's move from float32 beside; every product shape of the
          card's step, forward and backward, against its plain version
          (check_product).
  mfu     scripts/mfu_profile_torch.py's report (pipeline/mfu.py's
          programs, utils/roofline.py's count): extract, fused odometry
          and register 256v256 with the information matrix on main's
          engine and frames 0-1, and one stage-1 step (S = 2) of the
          train phase's config, each a chain of calls ending in one
          synchronize, each under `tpu.bf16` on ("bfloat16": the
          network's products at the bfloat16 rate) and off ("highest");
          one line a program with ms, GFLOP, GB (its
          inputs, weights and outputs once; unfused_gbytes beside),
          mfu, hbm_share, roofline_share (bound_by), matmul_policy and the
          card's name and power limit. Fails if a share reads
          outside (0, 1] (the count would be wrong) or K1 / K2 did not
          launch.
  export  the train phase's weights_final.msgpack written in the
          reference's .pth schema (save_torch_weight) and read back through
          pipeline/common.load_weights (state dicts bit-equal); the train
          scene's first 16 frames through pipeline.infer with the .pth and
          with the msgpack (trajectory files identical byte for byte); the
          JAX package's artifacts/full_size model on the recipe's two-lap
          world (96 frames, full_eval_args, loops on) through the port:
          every frame accepted or dropped by the system's rules, aligned
          and unaligned ATE, keyframes and loop edges (not gated). Launches
          counted from a reset before the two infer runs; K1 and K2 must
          launch.
  demo    pipeline/demo.main (the demo-width recipe) on the card: its
          60-frame world, DEMO_STEPS steps a stage, weights written and read
          back into the demo model, SLAM around the loop; then the committed
          artifacts/synthetic_demo through run_sequence on that world. The
          ATE, keyframes and loop edges of each (not gated); K1 / K2
          launches at the demo width required.
  scale   pipeline/scale.run_scale(300, 100) with the committed demo
          weights, bench.py's scale block: every frame mapped, no stage
          error; loop_floor_ok, the ATE, scans/s a block and the growth of
          the host RSS and of the card's allocated memory (not gated).
  evaluate  the port's evaluation CLI (python -m
          deeppointmap_tpu_torch.pipeline.evaluate --json) on slam_a's
          trajectory against its ground truth, aligned and not: its JSON
          equals utils/evaluation's numbers computed in process.
  bf16    `tpu.encoder_bf16` on the card: main's frames through an engine
          with the option off and on (ms a frame for each, the features'
          relative error; coordinates and validity must be identical),
          frame 0 through the CPU engine with the encoder's gate forced to
          bfloat16 (`bf16_vs_cpu`: validity identical, mean abs difference
          <= BF16_CPU_RATIO of the bf16-vs-f32 one), the accuracy world
          with loops on under bfloat16 (the path's launches are counted
          here alone; aligned ATE beside the float32 run's, not gated),
          and one stage-1 training step
          (train's config, the trained weights) with the option off and
          on: each loss must be finite.
  cpu     frames 0-2 of `main` on the CPU (the plain versions), and frames
          0-2 of slam_a through a CPU SlamSystem, held to the GPU's: with
          `tpu.bf16: false` on both sides (main_f32 and a GPU SlamSystem
          run) under F32_GATES, the port's float32 gates; and under the
          "bfloat16" rule on both sides (main, slam_a; the CPU's plain
          version forced): descriptors also at most BF16_CPU_RATIO of the
          rule's move from float32 on the card, poses within F32_GATES or
          SPREAD_FACTOR x the CPU's own spread under the rule (float64_sums,
          ulp_nudge), the larger. Every card-against-CPU gate's
          disagreement (here, host_chain, train) fails the script here,
          after the readings are printed.
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
failure raises and the script exits non-zero. TF32 is off throughout:
distances at +-60 m need full f32 (the rule's products are bfloat16
operands with float32 accumulation, not TF32). A
kernel's time is that of a run of launches between one pair of CUDA events
(`timed`), with the wrapper's host time a call beside it.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import filecmp
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

from deeppointmap_tpu_torch.ops.neighbors import in_radius_pairs
from deeppointmap_tpu_torch.pipeline import full_size
from deeppointmap_tpu_torch.utils import precision, roofline

SEED = 0
N_PAD = 16384
N_FRAMES = 8
CPU_FRAMES = 3
#: frames of the bf16 phase held against the CPU encoder forced to bfloat16,
#: and the bound on a bfloat16 card-against-CPU difference as a share of
#: the card's bfloat16-against-float32 one (tpu.encoder_bf16's features,
#: and the tpu.bf16 rule's descriptors)
BF16_CPU_FRAMES = 1
BF16_CPU_RATIO = 0.5
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
#: the sharded phase's scans (two replicas at 4 scans a replica pad a tail)
SHARDED_SCANS = 10
#: the native phase: slam_a's first raw scans, and a KITTI-size scan
NATIVE_FRAMES = 8
KITTI_POINTS = 122880
WEIGHTS = "artifacts/full_size_occ_v2/weights_final.msgpack"
#: the train phase's scene: the full-size recipe's first training scene
#: (deeppointmap_tpu_torch/pipeline/full_size.py TRAIN_SCENES[0]: world
#: seed 1, a 20 m circle) under its compact world and render settings
TRAIN_SCENE = dict(seed=full_size.TRAIN_SCENES[0][0],
                   radius=full_size.TRAIN_SCENES[0][1],
                   frames=full_size.FRAMES_PER_SCENE)
TRAIN_WORLD = full_size.DEFAULT_WORLD
TRAIN_RENDER = full_size.DEFAULT_RENDER
#: frames a training step encodes at once: stage 1 at K = 3 gives 4 (S = 2:
#: K_max // S = 2 map groups) or 3 (S = 3: one group), stage 2 four a side,
#: the GPU-against-CPU check 2 (one group of S = 2)
TRAIN_BATCHES = (2, 3, 4)
#: steps of stage 1 with and without tpu.remat, in process
REMAT_STEPS = 6
#: frames of the train scene run through pipeline/infer with the trained
#: weights
TRAIN_INFER_FRAMES = 16
TRAIN_TIMEOUT_S = 420
#: the train phase's config file in the run's temporary directory (the
#: bf16 phase steps on it too)
TRAIN_YAML = "train.yaml"
#: the demo-width model (pipeline/demo.py, artifacts/synthetic_demo): the
#: frames one K1 / K2 launch holds -- 1 in SLAM, 4 in the pipelined
#: warm-up's batch and in stage 2's steps, 6 in stage 1's (K 3 beside a
#: map group of 3)
DEMO_BATCHES = (1, 4, 6)
DEMO_WEIGHTS = "artifacts/synthetic_demo/weights_final.msgpack"
#: the demo phase: the recipe's own 60-frame world, cut to these steps a
#: stage
DEMO_FRAMES = 60
DEMO_STEPS = (20, 10)
#: the scale phase: bench.py's scale block (three drifting laps)
SCALE_FRAMES = 300
SCALE_BLOCK = 100
#: the mfu phase: calls a program (a chain), and stage-1 steps
MFU_TRIALS = 10
MFU_TRAIN_TRIALS = 5
#: the precision phase: main's frames whose product shapes are recorded,
#: the map-tile token counts of its attention shapes (reg_buckets), and
#: the bound on the cuBLAS route's relerr against its plain version
PRECISION_FRAMES = 3
PRECISION_TOKENS = (256, 1024, 4096)
PRECISION_RELERR = 1e-5
#: GPU against CPU on main's frames 0 .. CPU_FRAMES-1, through SlamSystem
#: and in one stage-1 step. Float32 on both sides (`tpu.bf16: false`): the
#: port's float32 gates. Under the `tpu.bf16` rule on both sides (cuBLAS
#: against the plain version) an operand a float32 ulp from a bfloat16
#: rounding boundary rounds the other way on one side, and the flip spreads
#: through the network, so the rule's pairs are held to what the same run
#: measures:
#:  - descriptors (no discrete choice upstream): relerr within the float32
#:    gate and at most BF16_CPU_RATIO of the rule's own move from float32
#:    on the card, which tells the rule from float32 and from a bfloat16
#:    output;
#:  - poses, exit codes aside, and a step's loss and median gradient:
#:    within the float32 gate or SPREAD_FACTOR x the CPU's own spread under
#:    the rule, the larger: the CPU's run against its reruns with the
#:    products' sums in float64 (`float64_sums`) and with every product's
#:    float32 input and incoming gradient moved one ulp (`ulp_nudge`, the
#:    freedom a float32 operation on another device has);
#:  - information: the float32 gate.
#: Each product shape of a training step, forward and backward, is held to
#: its plain version besides (`check_product`).
F32_GATES = dict(desc_relerr=1e-3, rot_deg=0.05, trans_m=0.01,
                 info_relerr=1e-2)
TRAIN_F32_GATES = dict(loss_relerr=1e-4, worst_grad_relerr=1e-3)
SPREAD_FACTOR = 2.0
#: disagreements found by the card-against-CPU gates; every phase still
#: runs and prints its readings, and the script fails before its last line
DISAGREED: list = []
REPO = os.path.dirname(os.path.abspath(__file__))
REPLACES = {"fps": "deeppointmap_tpu/ops/pallas_fps.py:111",
            "knn": "deeppointmap_tpu/ops/pallas_knn.py:192",
            "moments": "deeppointmap_tpu/ops/pallas_moments.py:94",
            "sweep": "deeppointmap_tpu/ops/pallas_sweep.py:147"}
SOURCES = {name: f"deeppointmap_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["kabsch"] = "deeppointmap_tpu_torch/csrc/kabsch.cu"
#: K5 against the plain solve in float64 on the same inputs (its answer
#: is float64's, rounded to float32 once): R's entries, t in meters
KABSCH_TOL = (2e-6, 2e-5)

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
#: the recipe's full_eval_args: the JAX package's accuracy block (no
#: outlier / low-pass filter, no distance floor, the RANSAC solve, loop
#: gates 0.6 / 0.3), for the same model trees as CONFIG
EVAL_TRANSFORMS = full_size.TRANSFORMS
EVAL_SLAM = json.loads(json.dumps(full_size.full_eval_args("", "")
                                  .slam_system))
#: the JAX package's numbers on that world and these args, for reference
#: only: TPU, as BASELINE.md records them (:502-504, 550-590), not the port's
JAX_TPU_REFERENCE = dict(
    source="JAX package on a TPU, as recorded in BASELINE.md",
    ate_aligned_m=4.52, ate_aligned_no_loop_m=6.06, ma_merged_ate_m=3.25,
    ma_cross_agent_loop_edges="80-83")


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


@functools.lru_cache(maxsize=None)
def card_peaks() -> roofline.Peaks:
    """The card's published peaks (utils/roofline.device_peaks: raises on
    a card it has none for)."""
    return roofline.device_peaks("cuda")[0]


def bound(cost: roofline.Cost) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") of a utils/roofline count."""
    return cost.bound_ms(card_peaks())


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
    bound_ms, by = bound(roofline.fps_cost(b, n, k, int(valid.sum())))
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
    """One K2 shape against the plain version; returns its entry, which
    names the route `knn_cuda` took. Tolerances: identical neighbour sets
    but for exact ties, dist2 relerr <= 1e-5 (the two are built to give the
    same bits; max_abs_err reports what they gave), and on the wide route
    indices and dist2 bit for bit; cnt equal, s and S6 within one float32
    ulp."""
    b, n, _ = points.shape
    s = centers.shape[1]
    got = nb.knn_cuda(points, centers, k, valid, radius)
    ref = nb.knn_plain(points, centers, k, valid, radius)
    torch.cuda.synchronize()
    got = [x.cpu().numpy() for x in got]
    ref = [x.cpu().numpy() for x in ref]
    route = nb.knn_route(k)
    bit_equal = bool(np.array_equal(got[0], ref[0])
                     and np.array_equal(got[1], ref[1]))
    if route == "wide" and not bit_equal:
        raise AssertionError(f"K2's wide route differs from its plain "
                             f"version at B={b} N={n} S={s} k={k}")
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
    cost = roofline.knn_cost(b, n, s, k, int(valid.sum()))
    if radius > 0:
        cost = cost + roofline.moments_cost(b, s, in_radius_pairs(
            points, valid, centers, radius))
    bound_ms, by = bound(cost)
    return dict(name="knn", shape=list(nb.knn_shape(b, n, s, k, radius)),
                valid_points=int(valid.sum()), route="cuda", k2_route=route,
                bit_equal=bit_equal, source=SOURCES["knn"],
                replaces=REPLACES["knn"], max_abs_err=err, ms=ms,
                host_us=host_us, plain_ms=plain_ms, bound_ms=bound_ms,
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


def encoder_knn_shapes(e, n_pad: int) -> list:
    """K2's (N, S, k, radius) in the encoder of config tree `e`: the first
    stage's grouping, one shared self-kNN a level (LEVEL_GRAPH_REUSE: the
    widest k the level and the next stage's grouping need) and the
    FeaturePropagation 3-NN."""
    npoint, n_lv = e.npoint, len(e.npoint)
    shapes = [(n_pad, npoint[0], e.nsample_list[0][0], 0.0)]
    shapes += [(npoint[i], npoint[i], k, 0.0)
               for i, k in enumerate(roofline.graph_ks(e))]
    for i in range(e.upsample_layers):
        shapes.append((npoint[n_lv - 1 - i], npoint[n_lv - 2 - i], 3, 0.0))
    return shapes


def demo_scans(n_frames: int, n_pad: int):
    """The demo world's first scans (pipeline/demo.write_world: world seed
    0, a 25 m circle of DEMO_FRAMES frames, 2000 points a scan), normalized
    by 60 m and padded: (n_frames, n_pad, 3) and validity."""
    from deeppointmap_tpu_torch.pipeline.demo import padded_scans

    pts, valid = padded_scans(DEMO_FRAMES, n_frames, n_pad)
    return pts / np.float32(60.0), valid


def demo_knn_inputs(torch, dev, scans, valid, b, n, s, seed):
    """Inputs at one demo-width K2 shape: B of the normalized demo scans
    where N is the pad, else random subsets of their valid points; the
    centers are the points themselves (S = N) or points plus noise."""
    g = np.random.default_rng(seed)
    out = [[], [], []]
    for i in range(b):
        if n == scans.shape[1]:
            pts, v = scans[i], valid[i]
        else:
            keep = g.choice(np.nonzero(valid[i])[0], n, replace=False)
            pts, v = scans[i][keep], np.ones(n, bool)
        if s == n:
            centers = pts
        else:
            ci = g.choice(np.nonzero(v)[0], s, replace=s > v.sum())
            centers = pts[ci] + g.normal(0, 0.002, (s, 3))
        for lst, x in zip(out, (pts, v, centers)):
            lst.append(x)
    t = lambda xs: torch.from_numpy(np.ascontiguousarray(
        np.stack(xs))).to(dev)
    return (t([x.astype(np.float32) for x in out[0]]), t(out[1]),
            t([x.astype(np.float32) for x in out[2]]))


def odd_knn_cases(torch, nb, dev, scan_pts, scan_valid, radius):
    """K2 off the paths' shapes: (name, points, valid, centers, k, radius)
    at k = 65, 128 (beyond the earlier limit of 64) and 512 (KNN_MAX_K) and
    on both sides of the wide route's threshold, on 4096 points of a scan
    and 1024 centers; on the scan itself at k = 128 without moments and at
    k = 128, 256 and 512 with moments at `radius` (the preprocess sweep's);
    on points that all occur twice (exact distance ties), and with fewer
    valid points than k, the last two with moments and a center count that
    is no multiple of a warp's four."""
    g = np.random.default_rng(SEED + 3)
    wide = knn_inputs(torch, dev, scan_pts, scan_valid, 4096, 1024, 0.0, 11)
    scan = knn_inputs(torch, dev, scan_pts, scan_valid, N_PAD, N_PAD,
                      radius, 12)
    kw = nb.KNN_WIDE_K
    pts = g.normal(size=(1, 3000, 3)).astype(np.float32)
    pts[:, 1500:] = pts[:, :1500]
    few_v = np.zeros((1, 3000), bool)
    few_v[0, g.permutation(3000)[:20]] = True
    t = lambda x: torch.from_numpy(x).to(dev)
    return [("k65", *wide, 65, 0.0), ("k128", *wide, 128, 0.0),
            ("k512", *wide, 512, 0.0), ("below_wide_k", *wide, kw - 1, 0.0),
            ("above_wide_k", *wide, kw + 1, 0.0),
            ("scan_k128", *scan, 128, 0.0),
            ("scan_k128_moments", *scan, 128, radius),
            ("scan_k256_moments", *scan, 256, radius),
            ("scan_k512_moments", *scan, 512, radius),
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


def sweep_cost(points, valid, k: int, radius: float) -> roofline.Cost:
    """K4's count at k (K3's at k = 0), with the radius moments when
    radius > 0, from this run's inputs."""
    b, n, _ = points.shape
    cost = roofline.sweep_cost(b, n, k, int(valid.sum()))
    if radius > 0:
        cost = cost + roofline.moments_cost(b, n, in_radius_pairs(
            points, valid, points, radius))
    return cost


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
    bound_ms, by = bound(sweep_cost(points, valid, 0, radius))
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
    err = 0.0
    if radius > 0:
        err = check_moment_values(got[2:], ref[2:], "K4")
    ms = timed_ms(torch, lambda: sw.fused_sweep_cuda(points, valid, k,
                                                     radius), 20)
    plain_ms = timed_ms(torch, lambda: sw.fused_sweep_plain(points, valid, k,
                                                            radius), 2)

    def library():
        d = torch.cdist(points, points)
        d = d.masked_fill(~valid[:, None, :], float("inf"))
        return torch.topk(d, min(k, n), dim=-1, largest=False)

    library_ms = timed_ms(torch, library, 10)
    bound_ms, by = bound(sweep_cost(points, valid, k, radius))
    return dict(name="sweep", shape=list(sw.sweep_shape(b, n, k, radius)),
                valid_points=int(valid.sum()), route="cuda",
                source=SOURCES["sweep"],
                replaces=REPLACES["sweep"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=library_ms)


def kabsch_inputs(torch, b: int, k: int, seed: int):
    """b sets of k pairs within ~60 m, dst a rotated, shifted, noisy src;
    weights in (0, 1]."""
    g = np.random.default_rng(seed)
    src = g.normal(size=(b, k, 3)) * 20.0
    axis = g.normal(size=(b, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = g.uniform(-np.pi, np.pi, size=(b, 1, 1))
    K = np.cross(axis[:, :, None], np.eye(3)[None], axis=1)
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    dst = np.einsum("bij,bkj->bki", R, src) + g.normal(size=(b, 1, 3)) * 5 \
        + g.normal(size=(b, k, 3)) * 0.05
    w = g.uniform(0.05, 1.0, size=(b, k))
    return [torch.from_numpy(x.astype(np.float32)).cuda()
            for x in (src, dst, w)]


def check_kabsch(torch, kabsch, b: int, k: int, seed: int = 0) -> dict:
    """One K5 shape (b solves of k pairs) against the plain solve in
    float64 (KABSCH_TOL); timed beside the plain solve in float32 and its
    torch.linalg.svd + det alone (`library_ms`). Returns its entry."""
    src, dst, w = kabsch_inputs(torch, b, k, seed)
    R, t = kabsch.solve_rt_cuda(src, dst, w)
    R64, t64 = kabsch._solve_rt_plain(src.double(), dst.double(), w.double())
    err_R = float((R.double() - R64).abs().max())
    err_t = float((t.double() - t64).abs().max())
    if k >= 3 and (err_R > KABSCH_TOL[0] or err_t > KABSCH_TOL[1]):
        raise AssertionError(f"K5 differs from its plain version at b={b} "
                             f"k={k}: R {err_R}, t {err_t}")
    ms, host = timed(torch, lambda: kabsch.solve_rt_cuda(src, dst, w), 20)
    plain_ms = timed_ms(torch, lambda: kabsch._solve_rt_plain(src, dst, w),
                        5)
    S = torch.randn(b, 3, 3, device=src.device)

    def library():
        u, _, vt = torch.linalg.svd(S)
        return torch.linalg.det(vt.transpose(-1, -2) @ u.transpose(-1, -2))

    library_ms = timed_ms(torch, library, 5)
    bound_ms, by = bound(roofline.kabsch_solve(k, b))
    return dict(name="kabsch", shape=list(kabsch.solve_shape(b, k)),
                route="cuda", source=SOURCES["kabsch"], replaces=None,
                max_abs_err=max(err_R, err_t), ms=ms, host_us=host,
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
    # K5's shapes follow the registrations' pair counts: a new one is
    # checked when a path first runs it, outside the path's counts
    new = [sh for sh in kernels.KABSCH.shapes
           if ("kabsch", sh) not in checked]
    if new:
        import torch

        from deeppointmap_tpu_torch.ops import kabsch

        with kernels.recording():
            for sh in new:
                entries.append(check_kabsch(torch, kabsch, *sh))
                checked.add(("kabsch", sh))
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


def compare_cpu(cpu, pts, valid, frames) -> tuple:
    """Frames 0 .. CPU_FRAMES-1 through `cpu` on the inputs the GPU run
    was given (`frames`, as drive_main_path gives them). -> (descriptor
    relerr, survivors, rotation, translation and info relerr a frame, the
    CPU's frames in the same form)."""
    out0 = cpu.extract(pts[:1], valid[:1])
    mine = [(*out0, None)]
    cmp = [dict(frame=0, desc_relerr=relerr(out0[0], frames[0][0]),
                survivors_diff=int(np.sum(out0[2] != frames[0][2])))]
    for i in range(1, CPU_FRAMES):
        pd, pdv, ppv, _ = frames[i - 1]
        out = cpu.odometry_step(pts[i:i + 1], valid[i:i + 1], pd[0], pdv[0],
                                pts[i - 1], ppv[0])
        mine.append((out[0], out[1], out[2], out[3:]))
        g = frames[i]
        cmp.append(dict(
            frame=i, desc_relerr=relerr(out[0], g[0]),
            survivors_diff=int(np.sum(out[2] != g[2])),
            rot_deg=rotation_deg(out[3][:3, :3], g[3][0][:3, :3]),
            trans_m=float(np.linalg.norm(out[3][:3, 3] - g[3][0][:3, 3])),
            info_relerr=relerr(out[6], g[3][3])))
    return cmp, mine


def compare_slam_cpu(cpu_log, gpu_log) -> list:
    """The first frames of slam_a through a CPU SlamSystem (K4's plain
    version) against another run: exit codes, rotation and translation."""
    out = []
    for i, ((c_code, c_pose), (g_code, g_pose)) in enumerate(zip(cpu_log,
                                                                 gpu_log)):
        out.append(dict(frame=i, code=c_code, code_gpu=g_code,
                        rot_deg=rotation_deg(c_pose[:3, :3], g_pose[:3, :3]),
                        trans_m=float(np.linalg.norm(c_pose[:3, 3]
                                                     - g_pose[:3, 3]))))
    return out


def spread_limits(gates: dict, spreads: list) -> list:
    """A frame's limits under the rule: each key of `gates` at the larger
    of its float32 gate and SPREAD_FACTOR x the largest reading of that
    frame among `spreads` (the CPU against its own reruns, lists of rows a
    frame)."""
    return [{key: max(limit, SPREAD_FACTOR * max(
                 [sp[i].get(key, 0.0) for sp in spreads]))
             for key, limit in gates.items()}
            for i in range(len(spreads[0]))]


def hold(what: str, rows: list, limits: list) -> dict:
    """Rows against limits (one dict a row, or one for all); a row over
    a limit, or with two exit codes, goes to DISAGREED. -> the limits,
    for the phase's line."""
    limits = limits if isinstance(limits, list) else [limits] * len(rows)
    for row, lim in zip(rows, limits):
        over = {k: (row[k], v) for k, v in lim.items()
                if k in row and not row[k] <= v}
        if over or row.get("code", 0) != row.get("code_gpu", 0):
            DISAGREED.append(dict(what=what, row=row, over=over))
    return limits[0] if len(set(map(str, limits))) == 1 else limits


def rule_frame_limits(moves: list, spreads: list) -> list:
    """main's frames under the rule: F32_GATES, descriptors also at most
    BF16_CPU_RATIO of the rule's move from float32 on the card (`moves`,
    one relerr a frame), rotation and translation also spread_limits'."""
    out = spread_limits(F32_GATES, spreads)
    for lim, move in zip(out, moves):
        lim.update(desc_relerr=min(F32_GATES["desc_relerr"],
                                   BF16_CPU_RATIO * move),
                   info_relerr=F32_GATES["info_relerr"])
    return out


@contextlib.contextmanager
def float64_sums(cuda: bool = False):
    """The plain version of the tpu.bf16 rule with its sums in float64
    (rounded to float32 once): another valid order of the same exact
    products, on CPU tensors (and on CUDA ones with `cuda`: a witness that
    leaves the card's other operations as they are)."""
    inner = precision._product

    def plain64(a, b, bias=None):
        if a.is_cuda and not cuda:
            return inner(a, b, bias)
        out = (a.double() @ b.double()).float()
        return out if bias is None else out + bias

    precision._product = plain64
    try:
        yield
    finally:
        precision._product = inner


@contextlib.contextmanager
def ulp_nudge(seed: int):
    """The tpu.bf16 rule with each product's first operand and the
    gradient reaching its output moved one float32 ulp up or down at
    random (seeded) before their bfloat16 rounding: the freedom that the
    float32 operations between the products (LayerNorm, softmax, the
    activations) have on another device, on CPU tensors. The gradient
    passes the move unchanged."""
    import torch

    inner = precision._rule_product
    g = torch.Generator().manual_seed(seed)

    def nudge(x):
        up = torch.rand(x.shape, generator=g) < 0.5
        moved = torch.where(up, torch.nextafter(x, x.new_tensor(np.inf)),
                            torch.nextafter(x, x.new_tensor(-np.inf)))
        return x + (moved - x).detach()

    def nudged(a, b, bias=None):
        if a.is_cuda:
            return inner(a, b, bias)
        y = inner(nudge(a), b, bias)
        if y.requires_grad:
            y.register_hook(nudge)
        return y

    precision._rule_product = nudged
    try:
        yield
    finally:
        precision._rule_product = inner


# ---------------------------------------------------------------- training
def sharded_phase(torch, kernels, entries, launched, smi, pts, valid,
                  enc_sd, dec_sd, pre, device="cuda") -> dict:
    """extract_sequence over one and two replicas on cuda:0 at 1 and 4
    scans a replica, each held to engine.extract (float32 uploads, the same
    device preprocessing): descriptors atol 2e-5, validity identical. Then
    the seconds make_sharded_extract takes to build the replicas, the
    operations that synchronise with the GPU in the built extractor's
    first `sequence` call on the same scans, and scans/s of its second."""
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.models.encoder import Encoder
    from deeppointmap_tpu_torch.parallel.sharded_extract import (
        extract_sequence, make_sharded_extract)
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    cfg = copy.deepcopy(CONFIG)
    cfg["tpu"]["upload_quant"] = "none"
    args = config_from_dict(cfg, multi_thread=False)
    engine = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                             device=device)
    ref = engine.extract(pts, valid)
    encoder = Encoder.from_config(args)
    dev = engine.device
    runs = {}
    for replicas in (1, 2):
        for per in (1, 4):
            out = extract_sequence(encoder, enc_sd, [dev] * replicas,
                                   engine.coor_scale, pts, valid,
                                   preprocess_cfg=pre, batch_per_device=per,
                                   tpu_cfg=args.tpu)
            name = f"sharded_r{replicas}_b{per}"
            t0 = time.perf_counter()
            extract = make_sharded_extract(encoder, enc_sd, [dev] * replicas,
                                           engine.coor_scale, pre, args.tpu)
            build_s = time.perf_counter() - t0
            with (sync_counter(torch) if device == "cuda"
                  else contextlib.nullcontext(collections.Counter())) as syncs:
                extract.sequence(pts, valid, per)
            kernels.reset_launches()
            t0 = time.perf_counter()
            extract.sequence(pts, valid, per)
            wall = time.perf_counter() - t0
            launches = launches_of(kernels, entries, name, launched)
            require(launches, ("fps", "knn"), name)
            err = float(np.abs(out[0] - ref[0]).max())
            same = bool(np.array_equal(out[1], ref[1])
                        and np.array_equal(out[2], ref[2]))
            if err > 2e-5 or not same or not np.isfinite(out[0]).all():
                raise AssertionError(f"{name}: descriptors {err} from the "
                                     f"engine's, validity equal: {same}")
            runs[name] = dict(
                replicas=replicas, batch_per_device=per, build_s=build_s,
                wall_s=wall, scans_per_s=len(pts) / wall,
                desc_max_abs_err=err,
                validity_equal=same, host_syncs=sum(syncs.values()),
                launches_by_shape={
                    f"{k.name}{list(sh)}": c for k in (kernels.FPS,
                                                       kernels.KNN)
                    for sh, c in sorted(k.shapes.items())})
    return dict(phase="sharded", card=smi, scans=len(pts),
                reference="engine.extract, upload_quant none", runs=runs)


def native_phase(native, voxel, syn, raw_scans, slam_a_calls, smi) -> dict:
    """The native voxel route against the NumPy one (identical indices, ms
    of each: median of 5) on slam_a's first raw scans and a KITTI-size
    scan of the same world; slam_a must have called the native library
    once a frame."""
    rng = np.random.default_rng(syn.STREAM_SEED)
    world = syn.make_world(rng, **syn.STREAM_WORLD)
    pose = syn.circle_trajectory(syn.STREAM_TRAJ["frames_per_lap"],
                                 syn.STREAM_TRAJ["radius"])[0]
    kitti = syn.render_scan(world, pose, sensor_range=60.0,
                            max_points=KITTI_POINTS, rng=rng)
    clouds = {f"slam_a_{i}": raw_scans[i] for i in range(NATIVE_FRAMES)}
    clouds["kitti_size"] = kitti
    rows = {}
    for name, xyz in clouds.items():
        ms = {}
        for route, fn in (("native", voxel.voxel_downsample_indices),
                          ("numpy", voxel.voxel_downsample_indices_numpy)):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                keep = fn(xyz, 0.3, "first")
                times.append((time.perf_counter() - t0) * 1e3)
            ms[route] = (float(np.median(times)), keep)
        if not np.array_equal(ms["native"][1], ms["numpy"][1]):
            raise AssertionError(f"native voxel route differs on {name}")
        rows[name] = dict(points=len(xyz), kept=len(ms["native"][1]),
                          native_ms=ms["native"][0], numpy_ms=ms["numpy"][0])
    if slam_a_calls != SLAM_A_FRAMES:
        raise AssertionError(f"slam_a called the native library "
                             f"{slam_a_calls} times for {SLAM_A_FRAMES} "
                             "frames")
    return dict(phase="native", card=smi, voxel_size=0.3, retention="first",
                library=str(native.build().name),
                slam_a_native_calls=slam_a_calls, slam_a_frames=SLAM_A_FRAMES,
                clouds=rows)


def bf16_extract(engines, pts, valid):
    """Each frame through the float32 and the bfloat16 engine, in turns
    (f32, bf16, bf16, f32): ms a frame (median) for each, coordinates and
    validity identical, the features' relative error -> (that dict, the
    first pass's outputs {bf16: [extract's output a frame]})."""
    out = {False: [], True: []}
    ms = {False: [], True: []}
    for order in ((False, True), (True, False)):
        for i in range(len(pts)):
            for on in order:
                t0 = time.perf_counter()
                r = engines[on].extract(pts[i:i + 1], valid[i:i + 1])
                ms[on].append((time.perf_counter() - t0) * 1e3)
                if order[0] is False:
                    out[on].append(r)
    d32, dbf = (np.concatenate([r[0] for r in out[on]]) for on in (False,
                                                                   True))
    c = d32.shape[-1] - 3
    same = bool(np.array_equal(d32[..., c:], dbf[..., c:]) and all(
        np.array_equal(a[j], b[j]) for a, b in zip(out[False], out[True])
        for j in (1, 2)))
    if not same or not np.isfinite(dbf).all():
        raise AssertionError("bf16: coordinates or validity differ from "
                             "the float32 run")
    f32, fbf = d32[..., :c], dbf[..., :c]
    return dict(frames=len(pts), extract_ms_f32=float(np.median(ms[False])),
                extract_ms_bf16=float(np.median(ms[True])),
                coordinates_validity_identical=same,
                feature_relerr=relerr(fbf, f32),
                feature_mean_abs_err=float(np.abs(fbf - f32).mean()),
                feature_scale=float(np.abs(f32).max())), out


def bf16_vs_cpu(torch, tenc, cpu_bf, pts, valid, out) -> dict:
    """The first BF16_CPU_FRAMES frames through `cpu_bf` (the bfloat16
    engine's config on the CPU) with the encoder's gate forced to bfloat16
    there, against the card's bfloat16 (`out[True]`) and float32
    (`out[False]`) descriptors of the same frames. Both sides round where
    Flax does; only the order of float32 sums differs, and a rounding that
    flips on it spreads downstream. A cast point placed elsewhere rounds
    independently of the CPU's, which puts the card's bfloat16 features as
    far from the CPU's as from float32 or farther. Raises unless validity
    and survivors are identical and the mean absolute difference to the
    CPU's bfloat16 features is at most BF16_CPU_RATIO of the one to the
    card's float32 features."""
    gate = tenc.activation_dtype
    tenc.activation_dtype = lambda act, device: (
        torch.bfloat16 if act == "bfloat16" else torch.float32)
    try:
        cpu = [cpu_bf.extract(pts[i:i + 1], valid[i:i + 1])
               for i in range(BF16_CPU_FRAMES)]
    finally:
        tenc.activation_dtype = gate
    c = cpu[0][0].shape[-1] - 3
    f_cpu, f_bf, f_32 = (np.concatenate([r[0][..., :c] for r in rs])
                         for rs in (cpu, out[True][:BF16_CPU_FRAMES],
                                    out[False][:BF16_CPU_FRAMES]))
    same = all(np.array_equal(a[j], b[j]) for a, b in zip(cpu, out[True])
               for j in (1, 2))
    both = np.concatenate([r[1] for r in cpu])
    d_cpu = np.abs(f_bf - f_cpu)[both]
    d_32 = np.abs(f_bf - f_32)[both]
    res = dict(frames=BF16_CPU_FRAMES, validity_identical=same,
               coordinates_identical=all(
                   np.array_equal(a[0][..., c:], b[0][..., c:])
                   for a, b in zip(cpu, out[True])),
               bit_equal_share=float((d_cpu == 0).mean()),
               bit_equal_share_f32=float((d_32 == 0).mean()),
               mean_abs_diff=float(d_cpu.mean()),
               mean_abs_diff_f32=float(d_32.mean()),
               ratio=float(d_cpu.mean() / d_32.mean()),
               limit=BF16_CPU_RATIO, relerr=relerr(f_bf, f_cpu))
    if not same or not res["ratio"] <= BF16_CPU_RATIO:
        raise AssertionError(f"bf16: the card's bfloat16 features do not "
                             f"follow the CPU's: {res}")
    return res


def bf16_train_steps(torch, kernels, entries, launched, cfg_path: str,
                     tmp: str, device="cuda") -> dict:
    """One stage-1 step of the Trainer from the trained weights on the
    train phase's config, with tpu.encoder_bf16 off and on (the same
    batch): each loss finite."""
    from deeppointmap_tpu_torch.config import config_from_yaml
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.pipeline.train import training_transforms
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    enc_sd, dec_sd = load_msgpack_weights(WEIGHTS)
    out = {}
    for on in (False, True):
        args = config_from_yaml(cfg_path)
        args.tpu.encoder_bf16 = on
        args.infer_tgt = os.path.join(tmp, f"bf16_train_{on}")
        rng = np.random.default_rng(0)
        ds = SlamDatasets(args, data_transforms=training_transforms(args,
                                                                    rng),
                          rng=rng)
        trainer = Trainer(args, ds, enc_sd, dec_sd, rng=rng, device=device)
        batch = next(trainer._iter_batches())
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(batch)["loss"])
        sec = time.perf_counter() - t0
        launches_of(kernels, entries, f"bf16_train_{'on' if on else 'off'}",
                    launched)
        out["on" if on else "off"] = dict(
            loss=loss, first_step_s=sec, act_dtype=trainer.encoder.act_dtype,
            params_float32=all(p.dtype == torch.float32
                               for p in trainer.encoder.parameters()))
        trainer.close()
        del trainer
        if not np.isfinite(loss):
            raise AssertionError(f"bf16 train step ({on}): loss {loss}")
    out["loss_relerr"] = abs(out["on"]["loss"] - out["off"]["loss"]) / abs(
        out["off"]["loss"])
    return out


# ------------------------------------------------------------- precision
@contextlib.contextmanager
def recorded_products(seen: dict):
    """Record (a shape, b shape, with a bias) of every product that takes
    the tpu.bf16 rule inside the block into `seen`."""
    inner = precision._rule_product

    def record(a, b, bias=None):
        seen[(tuple(a.shape), tuple(b.shape), bias is not None)] = None
        return inner(a, b, bias)

    precision._rule_product = record
    try:
        yield seen
    finally:
        precision._rule_product = inner


def product_shapes(engine, pts, valid, poses) -> list:
    """[(a shape, b shape, with a bias)] of every distinct product the
    `tpu.bf16` rule ran on main's first PRECISION_FRAMES frames, and the
    two attention products (8 heads) at each of PRECISION_TOKENS
    tokens."""
    with recorded_products({}) as seen:
        drive_main_path(engine, pts[:PRECISION_FRAMES],
                        valid[:PRECISION_FRAMES], poses[:PRECISION_FRAMES])
    heads = 8
    d = int(engine.args.decoder.model_channel) // heads
    for t in PRECISION_TOKENS:
        seen[((heads, t, d), (heads, d, t), False)] = None
        seen[((heads, t, t), (heads, t, d), False)] = None
    return list(seen)


def check_product(torch, shape_a, shape_b, with_bias: bool, seed: int,
                  train: bool = False):
    """One product shape: the cuBLAS route (the operands' rounding and one
    call with bfloat16 operands and a float32 output) against its plain
    version on the same inputs (raises above PRECISION_RELERR). Then its ms
    beside the float32 product's (torch.mm / bmm / addmm, TF32 off); or,
    with `train`, its gradients dA and dB through the autograd Function
    against the exact sums of the rounded operands (float64): each within
    PRECISION_RELERR or SPREAD_FACTOR x the float32 plain version's own
    error, the larger (a long sum over the rows in dB)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(shape_a, device="cuda", generator=g)
    b = torch.randn(shape_b, device="cuda", generator=g)
    bias = torch.randn(shape_b[-1], device="cuda", generator=g) \
        if with_bias else None
    err_of = lambda got, want: float((got.double() - want).abs().max()
                                     / want.abs().max().clamp(min=1e-30))
    with torch.no_grad():
        route = lambda: precision._rule_product(a, b, bias)
        got = route()
        want = precision.plain(a, b)
        err = err_of(got, want if bias is None else want + bias)
        del want
    out = dict(a=list(shape_a), b=list(shape_b), bias=with_bias,
               relerr=err)
    if train:
        a_g, b_g = a.clone().requires_grad_(), b.clone().requires_grad_()
        dy = torch.randn(got.shape, device="cuda", generator=g)
        precision._rule_product(a_g, b_g, bias).backward(dy)
        r = lambda x: x.to(torch.bfloat16).double()
        t = lambda x: x.transpose(-1, -2)
        for name, grad, (x, y) in (("da", a_g.grad, (dy, t(b))),
                                   ("db", b_g.grad, (t(a), dy))):
            exact = r(x) @ r(y)
            own = err_of(precision.plain(x, y), exact)
            out[name] = dict(relerr=err_of(grad, exact), plain_relerr=own,
                             limit=max(PRECISION_RELERR,
                                       SPREAD_FACTOR * own))
            del exact
        bad = [k for k in ("da", "db") if not out[k]["relerr"]
               <= out[k]["limit"]]
    else:
        with torch.no_grad():
            mm = torch.bmm if a.dim() == 3 else torch.mm
            f32 = (lambda: mm(a, b)) if bias is None else \
                (lambda: torch.addmm(bias, a, b))
            reps = 5 if a.numel() + got.numel() > 2 ** 24 else 20
            ms, host = timed(torch, route, reps)
            flops = 2.0 * int(np.prod(shape_a[:-1])) * shape_a[-1] \
                * shape_b[-1]
            out.update(ms=ms, host_us=host, f32_ms=timed_ms(torch, f32, reps),
                       bf16_tflops=flops / ms * 1e-9)
        bad = []
    if not err <= PRECISION_RELERR or got.dtype != torch.float32 or bad:
        raise AssertionError(f"precision: the cuBLAS route disagrees with "
                             f"its plain version: {out}")
    return out


def precision_phase(torch, kernels, entries, launched, smi, engine,
                    states, pts, valid, poses, main_out, f32, acc_cfg,
                    acc_dir, acc, gt, tmp) -> dict:
    """The `tpu.bf16` rule on the card: every product shape of main's
    frames and the attention's at PRECISION_TOKENS through the cuBLAS
    route against the plain version; main's frames under the rule
    (`main_out`) against `tpu.bf16: false` (`f32`, main_f32's); the accuracy
    world's ATE, loops on and off, under `tpu.bf16: false` beside `acc`
    (the accuracy phase's, under the rule)."""
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.pipeline import infer
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    t0 = time.perf_counter()
    if not precision.route_available():
        raise AssertionError(f"precision: torch {torch.__version__} has no "
                             f"bfloat16 -> float32 cuBLAS products")
    kernels.reset_launches()
    recorded = product_shapes(engine, pts, valid, poses)
    launches = launches_of(kernels, entries, "precision_shapes", launched)
    require(launches, ("fps", "knn"), "precision_shapes")
    shapes = [check_product(torch, *sh, seed)
              for seed, sh in enumerate(recorded)]
    frames = []
    for i, (bf, fl) in enumerate(zip(main_out["frames"], f32["frames"])):
        row = dict(frame=i, desc_relerr=relerr(bf[0], fl[0]),
                   survivors_diff=int(np.sum(bf[2] != fl[2])))
        if bf[3] is not None:
            row.update(rot_deg=rotation_deg(bf[3][0][:3, :3],
                                            fl[3][0][:3, :3]),
                       trans_m=float(np.linalg.norm(bf[3][0][:3, 3]
                                                    - fl[3][0][:3, 3])),
                       conf=[float(bf[3][1]), float(fl[3][1])])
        frames.append(row)
    runs = {}
    kernels.reset_launches()
    for name, loops in (("loops_on", True), ("loops_off", False)):
        cfg_e = copy.deepcopy(acc_cfg)
        cfg_e["tpu"]["bf16"] = False
        cfg_e["slam_system"].update(enable_loop_closure=loops,
                                    enable_global_optimization=loops)
        args_e = config_from_dict(cfg_e, multi_thread=False)
        engine_e = InferenceEngine(
            args_e, *states, device="cuda",
            preprocess_cfg=infer.device_preprocess_config(args_e))
        if engine_e.matmul_policy != precision.HIGHEST:
            raise AssertionError("precision: tpu.bf16 false is not float32")
        out_e = os.path.join(tmp, f"out_acc_f32_{name}")
        system_e, log_e, sec_e = run_slam(infer, args_e, engine_e, acc_dir,
                                          out_e)
        sm = slam_summary(system_e, [c for c, _ in log_e], sec_e, out_e, gt,
                          max_drop_share=None)
        runs[name] = dict(
            ate_aligned_m=sm["ate_aligned_m"], ate_unaligned_m=sm["ate_m"],
            frames_accepted=sm["frames"] - sm["dropped"],
            keyframes=sm["keyframes"], loop_edges=sm["loop_edges"],
            scans_per_s=sm["scans_per_s"])
    acc_launches = launches_of(kernels, entries, "precision_accuracy_f32",
                               launched)
    require(acc_launches, ("fps", "knn"), "precision_accuracy_f32")
    bf = {k: {key: acc[k][key] for key in runs[k]} for k in runs}
    return dict(
        phase="precision", card=smi, policy=engine.matmul_policy,
        torch=torch.__version__,
        relerr_limit=PRECISION_RELERR, shapes=shapes,
        main=dict(frames=frames, extract_first_ms=dict(
                      bf16=main_out["summary"]["extract_first_ms"],
                      f32=f32["summary"]["extract_first_ms"]),
                  odometry_ms_median=dict(
                      bf16=main_out["summary"]["frame_ms_median"],
                      f32=f32["summary"]["frame_ms_median"]),
                  pose_err_vs_gt=dict(bf16=main_out["summary"]["pose_err"],
                                      f32=f32["summary"]["pose_err"])),
        shapes_launches=launches,
        accuracy=dict(frames=len(gt), bf16=bf, f32=runs,
                      jax_tpu_reference=JAX_TPU_REFERENCE,
                      launches=acc_launches),
        seconds=time.perf_counter() - t0)


def train_config(root: str, out: str) -> dict:
    """The recipe's full_train_args (deeppointmap_tpu_torch/pipeline/
    full_size.py) cut to the train scene and one epoch of each stage:
    DeepPointMap-B at the 16384-point pad, batch 1 in stage 1 (AdamW,
    cosine) and 4 in stage 2 (Adam, cosine), a checkpoint and a log line
    every epoch. K_0 is 3 where the recipe starts at 2: with one stage-1
    epoch the curriculum never grows, and K = 3 gives steps of both 4 and
    3 frames."""
    cfg = json.loads(json.dumps(full_size.full_train_args(root, out, 1, 1)))
    for key in ("multi_thread", "num_workers", "profile"):
        cfg.pop(key)
    cfg["dataset"][0]["scenes"] = ["scene0"]
    cfg["train"].update(save_cycle=1, log_cycle=1, keep_checkpoints=2)
    cfg["train"]["registration"]["K_0"] = 3
    cfg["tpu"] = dict(encoder_points=N_PAD, remat=False, encoder_bf16=False)
    return cfg


def render_train_scene(syn, root: str) -> str:
    """The train scene as an npz sequence (scene0/0 under `root`), as the
    recipe's build_training_worlds renders it."""
    rng = np.random.default_rng(TRAIN_SCENE["seed"])
    world = syn.make_world(rng, **TRAIN_WORLD)
    poses = syn.circle_trajectory(TRAIN_SCENE["frames"],
                                  radius=TRAIN_SCENE["radius"])
    return syn.write_npz_sequence(root, world, poses, rng=rng,
                                  **TRAIN_RENDER)


def step_stats(rows) -> dict:
    """A stage's steps.jsonl rows -> seconds a step (the median after the
    first step), the host's share (batch building over the whole step),
    the first step's seconds and the peak device bytes."""
    tail = rows[1:] or rows
    total = [r["batch_s"] + r["step_s"] for r in tail]
    return dict(steps=len(rows),
                sec_per_step_median=float(np.median(total)),
                batch_s_median=float(np.median([r["batch_s"] for r in tail])),
                step_s_median=float(np.median([r["step_s"] for r in tail])),
                host_share=sum(r["batch_s"] for r in tail) / sum(total),
                first_step_s=rows[0]["batch_s"] + rows[0]["step_s"],
                peak_bytes=max(r["peak_bytes"] or 0 for r in rows))


def per_step(counts: dict, steps: int) -> dict:
    return {f"{k}{list(sh)}": c / steps for (k, sh), c in
            sorted(counts.items())}


def train_phase(torch, kernels, entries, launched, smi, tmp,
                device="cuda") -> dict:
    """pipeline.train as a subprocess on the card (one epoch of each
    stage, warm-started from WEIGHTS), the freeze across stage 2, the
    trained weights through pipeline/infer, stage 1 with and without
    tpu.remat in process, and one stage-1 batch of two frames on the GPU
    against the CPU. Raises on any failed check."""
    import yaml

    from deeppointmap_tpu_torch.config import config_from_dict, \
        config_from_yaml
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.models.decoder import Decoder
    from deeppointmap_tpu_torch.models.encoder import Encoder
    from deeppointmap_tpu_torch.models.loss import LossConfig
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.parallel.train_step import (
        registration_metrics, to_device)
    from deeppointmap_tpu_torch.pipeline import infer
    from deeppointmap_tpu_torch.pipeline.batching import \
        build_registration_batch
    from deeppointmap_tpu_torch.pipeline.train import training_transforms
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    t_phase = time.perf_counter()
    root, out = os.path.join(tmp, "train_world"), os.path.join(tmp,
                                                               "train_log")
    agent_dir = render_train_scene(syn, root)
    cfg_path = os.path.join(tmp, TRAIN_YAML)
    with open(cfg_path, "w") as f:
        # in key order: the training transforms run in the order of the
        # `transforms:` keys (sorted, the normalization would come before
        # the 0.3 m voxel downsample and leave ~25 points a frame)
        yaml.safe_dump(train_config(root, out), f, sort_keys=False)

    # -- the CLI, one epoch of each stage, on the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeppointmap_tpu_torch.pipeline.train",
         "--yaml_file", cfg_path, "--weight", WEIGHTS, "--device", device],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=TRAIN_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"pipeline.train exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    with open(os.path.join(out, "steps.jsonl")) as f:
        steps = [json.loads(x) for x in f]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        metrics = [json.loads(x) for x in f]
    bad = [m for m in metrics if not all(np.isfinite(v) for v in m.values())]
    if bad or not metrics:
        raise AssertionError(f"train: {len(bad)} non-finite metric lines")
    checked = {(en["name"], tuple(en["shape"])) for en in entries}
    stages = {}
    for stage in (1, 2):
        rows = [r for r in steps if r["stage"] == stage]
        counts = collections.Counter()
        for r in rows:
            for name, sh, c in r["launches"]:
                counts[(name, tuple(sh))] += c
        unchecked = [key for key in counts if key not in checked]
        if unchecked:
            raise AssertionError(f"train stage {stage} ran at unchecked "
                                 f"shapes {unchecked}")
        for key, c in counts.items():
            launched.setdefault(key, {})[f"train_stage{stage}"] = c
        frames = {sh[0] for name, sh in counts if name == "fps"}
        need = {3, 4} if stage == 1 else {4}
        if not need <= frames or not any(name == "knn" and sh[0] in need
                                         for name, sh in counts):
            raise AssertionError(f"train stage {stage}: K1 / K2 not at the "
                                 f"training shapes: {sorted(counts)}")
        keys = ("loss", "top1_acc") if stage == 1 else \
            ("loss", "acc", "precision", "recall")
        mean = [m for m in metrics if m["stage"] == stage][-1]
        stages[stage] = dict(
            **step_stats(rows), launches_per_step=per_step(counts, len(rows)),
            frames_per_step=dict(collections.Counter(
                max((sh[0] for name, sh, _ in r["launches"] if name == "fps"),
                    default=0)
                for r in rows)),
            first={k: rows[0]["metrics"][k] for k in keys},
            last={k: rows[-1]["metrics"][k] for k in keys},
            epoch_mean={k: mean[k] for k in keys})

    # -- stage 2 trains the loop head only
    ckpt = torch.load(os.path.join(out, "checkpoints", "checkpoint_ep1.pt"),
                      map_location="cpu", weights_only=True)
    final_enc, final_dec = load_msgpack_weights(
        os.path.join(out, "weights_final.msgpack"))
    moved = [k for k, v in final_enc.items()
             if not torch.equal(v, ckpt["encoder"][k])]
    moved += [k for k, v in final_dec.items() if not k.startswith("loop")
              and not torch.equal(v, ckpt["decoder"][k])]
    loop_moved = sum(not torch.equal(v, ckpt["decoder"][k])
                     for k, v in final_dec.items() if k.startswith("loop"))
    if moved or not loop_moved:
        raise AssertionError(f"stage 2 moved {moved[:5]}; loop head tensors "
                             f"moved: {loop_moved}")

    # -- the trained weights through pipeline/infer
    seq = os.path.join(tmp, "train_infer")
    os.makedirs(seq)
    for i in range(TRAIN_INFER_FRAMES):
        shutil.copy(os.path.join(agent_dir, f"{i}.npz"), seq)
    args_i = config_from_dict(CONFIG, multi_thread=False)
    engine = InferenceEngine(args_i, final_enc, final_dec, device=device,
                             preprocess_cfg=infer.device_preprocess_config(
                                 args_i))
    kernels.reset_launches()
    _, log_i, _ = run_slam(infer, args_i, engine, seq,
                           os.path.join(tmp, "train_infer_out"))
    launches_of(kernels, entries, "train_infer", launched)
    codes = [c for c, _ in log_i]
    if len(codes) != TRAIN_INFER_FRAMES:
        raise AssertionError(f"infer ran {len(codes)} frames")
    rows = np.loadtxt(os.path.join(tmp, "train_infer_out",
                                   "trajectory.allframes.txt"), ndmin=2)
    if not np.isfinite(rows).all():
        raise AssertionError("infer with the trained weights: non-finite")

    # -- stage 1 with and without remat, the same batches, in process
    enc_sd, dec_sd = load_msgpack_weights(WEIGHTS)
    remat = {}
    for on in (False, True):
        args = config_from_yaml(cfg_path)
        args.tpu.remat = on
        args.infer_tgt = os.path.join(tmp, f"remat_{on}")
        rng = np.random.default_rng(0)
        ds = SlamDatasets(args, data_transforms=training_transforms(args,
                                                                    rng),
                          rng=rng)
        trainer = Trainer(args, ds, enc_sd, dec_sd, rng=rng, device=device)
        batches = trainer._iter_batches()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        secs, losses = [], []
        for _ in range(REMAT_STEPS):
            batch = next(batches)
            t0 = time.perf_counter()
            losses.append(trainer.train_step(batch)["loss"])
            secs.append(time.perf_counter() - t0)
        counts = {(k.name, sh): c for k in kernels.ALL
                  for sh, c in k.shapes.items()}
        launches_of(kernels, entries, f"train_remat_{'on' if on else 'off'}",
                    launched)
        remat["on" if on else "off"] = dict(
            step_s_median=float(np.median(secs[1:])), losses=losses,
            peak_bytes=(torch.cuda.max_memory_allocated()
                        if device == "cuda" else None),
            launches_per_step=per_step(counts, REMAT_STEPS))
        trainer.close()
        del trainer
    if not np.allclose(remat["on"]["losses"], remat["off"]["losses"],
                       rtol=1e-4):
        raise AssertionError(f"remat changed the loss: {remat}")

    # -- one stage-1 batch of two frames, GPU against CPU
    args = config_from_yaml(cfg_path)
    args.train.registration.fill = False           # one map group
    rng = np.random.default_rng(1)
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    ds.forced_S = 2
    frames, info = ds[0]
    batch = build_registration_batch(frames, info, args.train.registration,
                                     N_PAD, rng)
    def step(dev, policy):
        enc = Encoder.from_config(args, policy)
        dec = Decoder.from_config(args, policy)
        enc.load_state_dict(enc_sd)
        dec.load_state_dict(dec_sd)
        enc.to(dev)
        dec.to(dev)
        m = registration_metrics(enc, dec, LossConfig.from_args(args),
                                 to_device(batch, dev), max_pairs=1024)
        m["loss"].backward()
        return float(m["loss"].detach()), {
            f"{part}.{k}": p.grad.detach().cpu()
            for part, mod in (("encoder", enc), ("decoder", dec))
            for k, p in mod.named_parameters() if p.grad is not None}

    def agreement(a, b) -> dict:
        """Loss relerr and every gradient's ||d|| / ||g|| of a against b."""
        errs = sorted((float(torch.linalg.vector_norm(a[1][k] - g)
                             / torch.linalg.vector_norm(g)), k)
                      for k, g in b[1].items()
                      if float(torch.linalg.vector_norm(g)) > 0)
        return dict(loss_relerr=abs(a[0] - b[0]) / abs(b[0]),
                    grad_relerr_median=errs[len(errs) // 2][0],
                    worst_grad_relerr=errs[-1][0],
                    worst_grad_tensor=errs[-1][1], tensors=len(b[1]),
                    same_tensors=set(a[1]) == set(b[1]))

    # float32 on both sides under the float32 gates; then the tpu.bf16
    # rule on both sides, held to the CPU's own spread under the rule, with
    # the card's own witnesses beside (the step again, its products summed
    # in float64); and every product shape of the card's step under the
    # rule, forward and backward, against its plain version
    runs, seen = {}, {}
    for policy in (precision.HIGHEST, precision.BF16):
        kernels.reset_launches()
        with recorded_products(seen):
            runs["gpu", policy] = step(device, policy)
        launches_of(kernels, entries, f"train_gpu_vs_cpu_{policy}",
                    launched)
        runs["cpu", policy] = step("cpu", policy)
    bf = precision.BF16
    runs["gpu_again", bf] = step(device, bf)
    with float64_sums(cuda=True):
        runs["gpu_float64_sums", bf] = step(device, bf)
    for name, witness in (("float64_sums", float64_sums()),
                          ("ulp_nudge", ulp_nudge(SEED))):
        with witness:
            runs[f"cpu_{name}", bf] = step("cpu", bf)
    if not all(r[1].keys() == runs["cpu", bf][1].keys()
               and np.isfinite(r[0]) for r in runs.values()):
        raise AssertionError("train step GPU vs CPU: a loss is not finite "
                             "or the gradients' tensors differ")
    f32 = agreement(runs["gpu", precision.HIGHEST],
                    runs["cpu", precision.HIGHEST])
    rule = dict(loss_gpu=runs["gpu", bf][0], loss_cpu=runs["cpu", bf][0],
                **agreement(runs["gpu", bf], runs["cpu", bf]))
    spread = {name: agreement(runs[f"cpu_{name}", bf], runs["cpu", bf])
              for name in ("float64_sums", "ulp_nudge")}
    card_witness = dict(
        again=agreement(runs["gpu_again", bf], runs["gpu", bf]),
        float64_sums=agreement(runs["gpu", bf],
                               runs["gpu_float64_sums", bf]),
        float64_sums_vs_cpu_float64_sums=agreement(
            runs["gpu_float64_sums", bf], runs["cpu_float64_sums", bf]),
        rule_vs_float32=agreement(runs["gpu", bf],
                                  runs["gpu", precision.HIGHEST]))
    gpu_vs_cpu = {
        precision.HIGHEST: dict(f32, gates=hold("train_f32", [f32],
                                                TRAIN_F32_GATES)),
        bf: dict(rule, cpu_spread=spread, card=card_witness,
                 limits=hold("train_bf16", [rule], spread_limits(
                     dict(loss_relerr=TRAIN_F32_GATES["loss_relerr"],
                          grad_relerr_median=TRAIN_F32_GATES[
                              "worst_grad_relerr"]),
                     [[sp] for sp in spread.values()])))}
    shapes = [check_product(torch, *sh, seed, train=True)
              for seed, sh in enumerate(seen)]
    return dict(
        phase="train", card=smi, config="scripts/train_full_size.py "
        "full_train_args, DeepPointMap-B, K_0 3, one epoch a stage",
        frames=TRAIN_SCENE["frames"], cli_exit=proc.returncode,
        cli_wall_s=cli_s, stage1=stages[1], stage2=stages[2],
        stage2_frozen_unchanged=True, loop_head_tensors_moved=loop_moved,
        infer=dict(frames=len(codes), codes={c: codes.count(c)
                                             for c in sorted(set(codes))}),
        remat=remat, gpu_vs_cpu=dict(frames=2, **gpu_vs_cpu),
        product_shapes=shapes,
        seconds=time.perf_counter() - t_phase)


def mfu_phase(torch, kernels, entries, launched, smi, tmp, engines, pts,
              valid) -> list:
    """The MFU report (pipeline/mfu.py, as scripts/mfu_profile_torch.py
    gives it) on the card: extract, fused odometry and register 256v256
    (+ the information matrix) on each of `engines` (main's, under the
    tpu.bf16 rule, and one with tpu.bf16 false) and frames 0-1,
    MFU_TRIALS calls each, and one stage-1 step of the train phase's
    config (its scene, DeepPointMap-B, S = 2 frames a group) from the
    trained weights under each policy, MFU_TRAIN_TRIALS steps. -> one line
    a program and policy; raises if a share reads outside (0, 1] or K1 /
    K2 did not launch."""
    from deeppointmap_tpu_torch.config import config_from_yaml
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.pipeline import mfu
    from deeppointmap_tpu_torch.pipeline.train import training_transforms
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    t0 = time.perf_counter()
    peaks, card = roofline.device_peaks("cuda")
    kernels.reset_launches()
    rows = []
    with torch.inference_mode():
        for engine in engines:
            rows += mfu.measure(mfu.engine_programs(engine, pts[:2],
                                                    valid[:2]),
                                MFU_TRIALS, "cuda", peaks, card)
    args = config_from_yaml(os.path.join(tmp, TRAIN_YAML))
    for policy in (engine.matmul_policy for engine in engines):
        rng = np.random.default_rng(0)
        ds = SlamDatasets(args, data_transforms=training_transforms(args,
                                                                    rng),
                          rng=rng)
        trainer = Trainer(args, ds, *load_msgpack_weights(WEIGHTS), rng=rng,
                          device="cuda", matmul_policy=policy)
        try:
            rows += mfu.measure([mfu.train_program(
                trainer, args, mfu.stage1_batch(args, ds, N_PAD))],
                MFU_TRAIN_TRIALS, "cuda", peaks, card)
        finally:
            trainer.close()
    launches = launches_of(kernels, entries, "mfu", launched)
    require(launches, ("fps", "knn"), "mfu")
    bad = [r["program"] for r in rows if not roofline.shares_ok(r)]
    if bad:
        raise AssertionError(f"mfu: a share outside (0, 1] in {bad}: the "
                             f"count claims more than the card can do")
    seconds = time.perf_counter() - t0
    return [dict(phase="mfu", card=smi, seconds=seconds, launches=launches,
                 **row) for row in rows]


def same_trajectory_files(out_a: str, out_b: str) -> list:
    """The trajectory and pose-graph files of two result trees, byte for
    byte. -> the relative paths compared; raises if one differs."""
    names = sorted(os.path.relpath(os.path.join(d, f), out_a)
                   for d, _, files in os.walk(out_a) for f in files
                   if f.startswith("trajectory.")
                   and f.endswith((".txt", ".g2o")))
    if not names:
        raise AssertionError(f"no trajectory files under {out_a}")
    differ = [rel for rel in names if not filecmp.cmp(
        os.path.join(out_a, rel), os.path.join(out_b, rel), shallow=False)]
    if differ:
        raise AssertionError(f"{differ} differ between {out_a} and {out_b}")
    return names


def export_phase(torch, kernels, entries, launched, smi, tmp,
                 device="cuda") -> dict:
    """The train phase's weights_final.msgpack written in the reference's
    .pth schema (models/weights.save_torch_weight) and read back through
    pipeline/common.load_weights: the state dicts bit-equal. Then, counted
    from a reset just before: TRAIN_INFER_FRAMES of the train scene through
    pipeline.infer's run_inference with the .pth and with the msgpack
    (identical trajectory files), and the JAX package's artifacts/full_size
    model on the recipe's two-lap world (96 frames, full_eval_args, loops
    on) through the port: every frame accepted or dropped by the system's
    own rules, the ATE printed (not gated). K1 and K2 must launch."""
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.models.weights import save_torch_weight
    from deeppointmap_tpu_torch.pipeline import infer
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine
    from deeppointmap_tpu_torch.slam.utils import EXIT_CODE

    t_phase = time.perf_counter()
    msgpack = os.path.join(tmp, "train_log", "weights_final.msgpack")
    pth = os.path.join(tmp, "train_log", "weights_final.pth")
    args = config_from_dict(CONFIG, multi_thread=False)
    states = load_weights(args, msgpack)
    save_torch_weight(pth, *states, args)
    back = load_weights(args, pth)
    for got, want in zip(back, states):
        if got.keys() != want.keys() or not all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want):
            raise AssertionError("export: the .pth does not read back to "
                                 "the msgpack's state dicts")

    kernels.reset_launches()
    outs = {}
    for name, weight in (("msgpack", msgpack), ("pth", pth)):
        outs[name] = os.path.join(tmp, f"export_{name}")
        infer.run_inference(config_from_dict(
            CONFIG, multi_thread=False, device=device, weight=weight,
            infer_src=[os.path.join(tmp, "train_infer")],
            infer_tgt=outs[name], profile=False))
    compared = same_trajectory_files(outs["msgpack"], outs["pth"])

    ref = os.path.join(REPO, "artifacts/full_size/weights_final.msgpack")
    full_size.apply_artifact_render(ref)
    root, out_e = (os.path.join(tmp, d) for d in ("export_world",
                                                  "export_eval"))
    full_size.build_eval_world(root)
    args_e = full_size.full_eval_args(root, out_e)
    engine = InferenceEngine(args_e, *load_weights(args_e, ref),
                             device=device,
                             preprocess_cfg=infer.device_preprocess_config(
                                 args_e))
    system, log, sec = run_slam(infer, args_e, engine, args_e.infer_src[0],
                                out_e)
    launches = launches_of(kernels, entries, "export", launched)
    require(launches, ("fps", "knn"), "export")
    lap = syn.circle_trajectory(full_size.EVAL_WORLD["frames_per_lap"],
                                radius=full_size.EVAL_WORLD["radius"])
    codes = [c for c, _ in log]
    rules = {c.name for c in EXIT_CODE} - {"exit"}
    if len(codes) != 2 * len(lap) or not set(codes) <= rules:
        raise AssertionError(f"export eval: {len(codes)} frames, codes "
                             f"{sorted(set(codes))}")
    sm = slam_summary(system, codes, sec, out_e, lap * 2,
                      max_drop_share=None)
    return dict(
        phase="export", card=smi, pth_bytes=os.path.getsize(pth),
        state_dicts_bit_equal=True, infer_frames=TRAIN_INFER_FRAMES,
        infer_files_identical=compared,
        reference_eval=dict(
            weights="artifacts/full_size/weights_final.msgpack",
            args="deeppointmap_tpu_torch/pipeline/full_size.py "
                 "full_eval_args, loops on",
            frames=len(codes), ate_aligned_m=sm["ate_aligned_m"],
            ate_unaligned_m=sm["ate_m"], codes=sm["codes"],
            frames_accepted=sm["frames"] - sm["dropped"],
            keyframes=sm["keyframes"], loop_edges=sm["loop_edges"],
            scans_per_s=sm["scans_per_s"]),
        launches=launches, seconds=time.perf_counter() - t_phase)


def demo_phase(torch, kernels, entries, launched, smi, tmp,
               device="cuda") -> dict:
    """pipeline/demo.main on the card (the recipe's world, DEMO_STEPS steps
    a stage), its weights read back, then the committed
    artifacts/synthetic_demo through run_sequence on the same world:
    frames, keyframes, loop edges and the aligned ATE of each (not gated).
    Each run's launches are counted from a reset before it; K1 and K2 must
    launch at the demo width (the recipe's steps and SLAM, the artifact's
    SLAM)."""
    from deeppointmap_tpu_torch.models.decoder import Decoder
    from deeppointmap_tpu_torch.models.encoder import Encoder
    from deeppointmap_tpu_torch.ops import neighbors, sampling
    from deeppointmap_tpu_torch.pipeline import demo
    from deeppointmap_tpu_torch.pipeline.common import load_weights

    t_phase = time.perf_counter()
    root, out = (os.path.join(tmp, d) for d in ("demo_world", "demo_out"))
    kernels.reset_launches()
    res = demo.main(["--steps", str(DEMO_STEPS[0]), "--loop_steps",
                     str(DEMO_STEPS[1]), "--frames", str(DEMO_FRAMES),
                     "--root", root, "--out", out, "--device", device])
    launches = launches_of(kernels, entries, "demo_recipe", launched)
    args = demo.demo_args(root, out)
    e, pad = args.encoder, int(args.tpu.encoder_points)
    at_width = {
        "fps": kernels.FPS.shapes[sampling.fps_shape(1, pad, e.npoint[0])],
        "knn": kernels.KNN.shapes[neighbors.knn_shape(
            1, pad, e.npoint[0], e.nsample_list[0][0], 0.0)],
        "fps_stage1": kernels.FPS.shapes[sampling.fps_shape(
            max(DEMO_BATCHES), pad, e.npoint[0])]}
    if min(at_width.values()) <= 0:
        raise AssertionError(f"demo: K1 / K2 idle at the demo width: "
                             f"{at_width} {launches}")
    back = load_weights(args, res["weights"])
    for sd, model in zip(back, (Encoder.from_config(args),
                                Decoder.from_config(args))):
        want = model.state_dict()
        if sd.keys() != want.keys() or not all(
                sd[k].shape == want[k].shape
                and bool(torch.isfinite(sd[k]).all()) for k in want):
            raise AssertionError("demo: the written weights do not read "
                                 "back into the demo model")
    kernels.reset_launches()
    artifact = demo.run_slam(args, os.path.join(REPO, DEMO_WEIGHTS),
                             os.path.join(tmp, "demo_artifact"), device)
    launches_a = launches_of(kernels, entries, "demo_artifact", launched)
    require(launches_a, ("fps", "knn"), "demo_artifact")
    if res["slam"]["frames"] + artifact["frames"] <= 0:
        raise AssertionError("demo: no frame in either graph")
    return dict(phase="demo", card=smi, frames=DEMO_FRAMES,
                steps=list(DEMO_STEPS), train=res["train"],
                trained=res["slam"], artifact=artifact,
                launches=launches, launches_at_demo_width=at_width,
                artifact_launches=launches_a,
                seconds=time.perf_counter() - t_phase)


def scale_phase(torch, kernels, entries, launched, smi, tmp,
                device="cuda") -> dict:
    """pipeline/scale.run_scale(SCALE_FRAMES, SCALE_BLOCK) with the
    committed demo weights, as bench.py's scale block: every frame mapped,
    no stage error (MT_Wait raises on one); loop_floor_ok, the ATE, scans/s
    and the growth of the host RSS and of the card's allocated memory are
    printed, not gated."""
    from deeppointmap_tpu_torch.pipeline.scale import run_scale

    t_phase = time.perf_counter()
    kernels.reset_launches()
    sm = run_scale(frames=SCALE_FRAMES, block=SCALE_BLOCK,
                   root=os.path.join(tmp, "scale_world"),
                   out=os.path.join(tmp, "scale_out"), quiet=True,
                   device=device)
    launches = launches_of(kernels, entries, "scale", launched)
    require(launches, ("fps", "knn"), "scale")
    if sm["frames_streamed"] != SCALE_FRAMES \
            or sm["frames_mapped"] != SCALE_FRAMES - 1:
        raise AssertionError(f"scale: {sm['frames_mapped']} of "
                             f"{sm['frames_streamed']} frames mapped")
    keep = ("frames", "keyframes", "loop_edges", "ate_m", "loop_floor_ok",
            "loop_gate_stats", "scans_per_sec_first_block",
            "scans_per_sec_last_block", "rss_growth_mb", "device_growth_mb",
            "device_max_mb", "blocks")
    return dict(phase="scale", card=smi, **{k: sm[k] for k in keep},
                launches=launches,
                seconds=time.perf_counter() - t_phase)


def evaluate_phase(out_a: str, gt_poses, tmp: str, smi) -> dict:
    """The port's evaluation CLI (python -m
    deeppointmap_tpu_torch.pipeline.evaluate --json) on slam_a's
    trajectory.allframes.txt against its ground truth (relative to frame 0,
    KITTI rows), aligned with --delta 1 and unaligned with --delta 3: each
    JSON must equal utils/evaluation's numbers computed here on the same
    files, with the CLI's rounding."""
    from deeppointmap_tpu_torch.utils import evaluation

    t_phase = time.perf_counter()
    pred_path = os.path.join(out_a, "trajectory.allframes.txt")
    gt_path = os.path.join(tmp, "slam_a_gt.txt")
    gt = np.stack([np.linalg.inv(gt_poses[0]) @ p for p in gt_poses])
    np.savetxt(gt_path, gt[:, :3, :].reshape(len(gt), 12))
    pred = evaluation.load_kitti_trajectory(pred_path)
    want_gt = evaluation.load_kitti_trajectory(gt_path)
    n = min(len(pred), len(want_gt))
    pred, want_gt = pred[:n], want_gt[:n]
    runs = {}
    for delta, align in ((1, True), (3, False)):
        flags = ["--delta", str(delta)] + ([] if align else ["--no-align"])
        out = subprocess.run(
            [sys.executable, "-m", "deeppointmap_tpu_torch.pipeline.evaluate",
             pred_path, gt_path, "--json", *flags], cwd=REPO,
            capture_output=True, text=True, check=True).stdout
        got = json.loads(out.strip().splitlines()[-1])
        rpe_t, rpe_r = evaluation.rpe(pred, want_gt, delta=delta)
        kt, kr = evaluation.kitti_odometry_errors(pred, want_gt)
        want = {
            "frames": n,
            "path_length_m": round(float(np.sum(np.linalg.norm(np.diff(
                want_gt[:, :3, 3], axis=0), axis=1))), 2),
            "ate_rmse_m": round(evaluation.ate_rmse(pred, want_gt,
                                                    align=align), 4),
            "ate_rmse_unaligned_m": round(evaluation.ate_rmse(
                pred, want_gt, align=False), 4),
            f"rpe_trans_m_delta{delta}": round(rpe_t, 4),
            f"rpe_rot_deg_delta{delta}": round(rpe_r, 4),
            "kitti_trans_err_pct": None if np.isnan(kt) else round(kt, 3),
            "kitti_rot_err_deg_per_100m": None if np.isnan(kr)
            else round(kr, 4)}
        if got != want:
            raise AssertionError(f"evaluate CLI {flags}: {got} != {want}")
        runs[" ".join(flags)] = got
    return dict(phase="evaluate", card=smi, pred="slam_a allframes",
                runs=runs, seconds=time.perf_counter() - t_phase)


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
    from deeppointmap_tpu_torch import kernels, native
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.data import voxel
    from deeppointmap_tpu_torch.data.preprocess import (PreprocessConfig,
                                                        preprocess)
    from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices
    from deeppointmap_tpu_torch.data.readers import read_auto
    from deeppointmap_tpu_torch.models import decoder as decoder_mod
    from deeppointmap_tpu_torch.models import encoder as tenc
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.ops import neighbors, normals, sampling, sweep
    from deeppointmap_tpu_torch.pipeline import infer
    from deeppointmap_tpu_torch.pipeline.demo import demo_args
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    kernels.strict_matmuls()
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
    raw = syn.render_stream(ACC_FRAMES)
    pts, valid, poses = syn.pad_stream(raw, N_FRAMES, N_PAD)
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
    # training encodes 2 or 3 frames at once too (B = 4 is checked above)
    for b in TRAIN_BATCHES:
        if b == WARMUP_BATCH:
            continue
        xb = torch.from_numpy(pts[:b] / 60.0).float().to(dev)
        entries.append(check_fps(torch, sampling, xb,
                                 torch.from_numpy(valid[:b]).to(dev),
                                 npoint[0]))
        for n, k in list(zip(n_in, npoint))[1:]:
            entries.append(check_fps(
                torch, sampling, torch.randn(b, n, 3, device=dev) * 0.3,
                torch.ones(b, n, dtype=torch.bool, device=dev), k))
    # the demo-width model (demo, scale): a real scan at the first stage
    dargs = demo_args("", "")
    d_pad, d_np = int(dargs.tpu.encoder_points), list(dargs.encoder.npoint)
    d_pts, d_valid = demo_scans(max(DEMO_BATCHES), d_pad)
    d_in = [d_pad] + d_np[:-1]
    for b in DEMO_BATCHES:
        entries.append(check_fps(torch, sampling,
                                 torch.from_numpy(d_pts[:b]).to(dev),
                                 torch.from_numpy(d_valid[:b]).to(dev),
                                 d_np[0]))
        for n, k in list(zip(d_in, d_np))[1:]:
            # 64 -> 16 is also a full-width stage, checked above
            if [b, n, k] not in [e["shape"] for e in entries]:
                entries.append(check_fps(
                    torch, sampling, torch.randn(b, n, 3, device=dev) * 0.3,
                    torch.ones(b, n, dtype=torch.bool, device=dev), k))
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
                  (N_PAD, N_PAD, k_reuse, pre.normals_radius)]
    knn_shapes += encoder_knn_shapes(e, N_PAD)
    # the warm-up's batch of four runs the level graphs and FP at B = 4;
    # training runs the stage-1 grouping, the level graphs and FP at the
    # frames of a step (TRAIN_BATCHES)
    # and offline extraction (phase sharded) preprocesses 4 scans at once
    batched = [(WARMUP_BATCH, *sh) for sh in knn_shapes[:1] + knn_shapes[4:]]
    batched += [(b, *sh) for b in TRAIN_BATCHES for sh in knn_shapes[3:]
                if (b, *sh) not in batched]
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
    # the demo-width model: its encoder at every batch, the information
    # matrix's 1-NN at its stride (no preprocess sweep: no filter)
    d_shapes = [(b, *sh) for b in DEMO_BATCHES
                for sh in encoder_knn_shapes(dargs.encoder, d_pad)]
    d_shapes.append((1, d_pad, -(-d_pad // int(dargs.tpu.infomat_stride)),
                     1, 0.0))
    for j, (b, n, s, k, radius) in enumerate(d_shapes):
        if [b, n, s, k, radius] in [e["shape"] for e in k2]:
            continue   # FP 16 -> 64 is a full-width shape too
        k2.append(check_knn(torch, neighbors, *demo_knn_inputs(
            torch, dev, d_pts, d_valid, b, n, s, 500 + j), k, radius))
    odd = {name: {key: en[key] for key in (
        "shape", "k2_route", "bit_equal", "ms", "host_us", "plain_ms",
        "bound_ms", "library_ms")}
           for name, p, v, c, k, radius in odd_knn_cases(
               torch, neighbors, dev, pts[0], valid[0], pre.normals_radius)
           for en in [check_knn(torch, neighbors, p, v, c, k, radius)]}
    emit(dict(phase="k2", card=smi, wide_k=neighbors.KNN_WIDE_K,
              odd_cases=odd, shapes=[
        {key: e[key] for key in ("shape", "k2_route", "bit_equal",
                                 "max_abs_err", "ms", "host_us", "plain_ms",
                                 "library_ms")} for e in k2]))
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

    # ------------------------------------------------------------------ K5
    # the RANSAC hypotheses and the refine solves of the 4096-token tile
    # (the paths' other pair counts are checked as they first run)
    from deeppointmap_tpu_torch.ops import kabsch
    k5 = [check_kabsch(torch, kabsch, kabsch.RANSAC_HYPOTHESES, 3),
          check_kabsch(torch, kabsch, 1, 2 * decoder_mod.num_pairs_for(
              4096, 256))]
    emit(dict(phase="k5", card=smi, shapes=[
        {key: en[key] for key in ("shape", "max_abs_err", "ms", "host_us",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")} for en in k5]))
    entries += k5

    # -------------------------------------------------------- main path
    enc_sd, dec_sd = load_msgpack_weights(WEIGHTS)
    engine = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                             device="cuda")
    launched = {}
    kernels.reset_launches()
    precision.reset_route_calls()
    main_out = drive_main_path(engine, pts, valid, poses)
    launches = launches_of(kernels, entries, "main", launched)
    bf16_products = precision.route_calls()
    if min(launches["fps"], launches["knn"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if engine.matmul_policy != precision.BF16 or bf16_products <= 0:
        raise AssertionError(f"main: the tpu.bf16 rule did not run "
                             f"({engine.matmul_policy}, {bf16_products} "
                             f"products)")
    emit(dict(phase="main", card=smi, **main_out["summary"],
              launches=launches, matmul_policy=engine.matmul_policy,
              bf16_products=bf16_products))
    # main_f32: the same frames with tpu.bf16 false (float32 products)
    cfg_f32 = copy.deepcopy(CONFIG)
    cfg_f32["tpu"]["bf16"] = False
    args_f32 = config_from_dict(cfg_f32, multi_thread=False)
    engine_f32 = InferenceEngine(args_f32, enc_sd, dec_sd,
                                 preprocess_cfg=pre, device="cuda")
    kernels.reset_launches()
    precision.reset_route_calls()
    main_f32 = drive_main_path(engine_f32, pts, valid, poses)
    launches = launches_of(kernels, entries, "main_f32", launched)
    require(launches, ("fps", "knn"), "main_f32")
    if engine_f32.matmul_policy != precision.HIGHEST or \
            precision.route_calls() != 0:
        raise AssertionError("main_f32: a product took the tpu.bf16 rule")
    emit(dict(phase="main_f32", card=smi, **main_f32["summary"],
              launches=launches, matmul_policy=engine_f32.matmul_policy))

    # ------------------------------------------- offline batch extraction
    pts_s, valid_s, _ = syn.pad_stream(raw, SHARDED_SCANS, N_PAD)
    emit(sharded_phase(torch, kernels, entries, launched, smi, pts_s,
                       valid_s, enc_sd, dec_sd, pre))

    # ------------------------------------- SLAM through the CLI's path
    with tempfile.TemporaryDirectory() as tmp:
        seq_a, seq_b, seq_c, seq_d, seq_h = (os.path.join(tmp, d)
                                             for d in "abcdh")
        syn.write_bins(raw[0][:SLAM_A_FRAMES], seq_a)
        syn.write_bins(raw[0][:SLAM_B_FRAMES], seq_b)
        syn.write_bins(raw[0][:CPU_FRAMES], seq_c)
        syn.write_bins(raw[0][SLAM_B_FRAMES:2 * SLAM_B_FRAMES], seq_d)
        syn.write_bins(raw[0][:HOST_FRAMES], seq_h)
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
        voxel_calls = native.LIB.voxel_calls
        system_a, log_a, sec_a = run_slam(infer, args_a, engine_a, seq_a,
                                          os.path.join(tmp, "out_a"))
        voxel_calls = native.LIB.voxel_calls - voxel_calls
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
        emit(native_phase(native, voxel, syn, raw[0], voxel_calls, smi))

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
        args_h.tpu.bf16 = False       # the host chain, not the rule, here
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
        hold("host_chain", host_cmp, F32_GATES)
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
            cfg_o["tpu"]["bf16"] = False   # the options, not the rule
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
        acc_dir = syn.write_npz(raw[0], raw[1],
                                os.path.join(tmp, "acc_world"))
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
                  matmul_policy=engine_e.matmul_policy,
                  ate_aligned_m=acc["loops_on"]["ate_aligned_m"],
                  ate_aligned_no_loop_m=acc["loops_off"]["ate_aligned_m"],
                  runs=acc, jax_tpu_reference=JAX_TPU_REFERENCE,
                  launches=launches))

        # precision: the tpu.bf16 rule's products, main and accuracy off
        emit(precision_phase(torch, kernels, entries, launched, smi, engine,
                             (enc_sd, dec_sd), pts, valid, poses, main_out,
                             main_f32, acc_cfg, acc_dir, acc, raw[1], tmp))

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
        tcp_dir = syn.write_npz(raw[0][:TCP_FRAMES], raw[1][:TCP_FRAMES],
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

        # ------------------------------------------------------ train
        emit(train_phase(torch, kernels, entries, launched, smi, tmp))

        # -------------------------------------------------------- mfu
        for line in mfu_phase(torch, kernels, entries, launched, smi, tmp,
                              (engine, engine_f32), pts, valid):
            emit(line)

        # ----------------------------------------------------- export
        emit(export_phase(torch, kernels, entries, launched, smi, tmp))

        # ------------------------------------------ demo, scale, evaluate
        emit(demo_phase(torch, kernels, entries, launched, smi, tmp))
        emit(scale_phase(torch, kernels, entries, launched, smi, tmp))
        emit(evaluate_phase(os.path.join(tmp, "out_a"),
                            raw[1][:SLAM_A_FRAMES], tmp, smi))

        # ------------------------------------------------------- bf16
        cfg_bf = copy.deepcopy(CONFIG)
        cfg_bf["tpu"]["encoder_bf16"] = True
        engine_bf = InferenceEngine(config_from_dict(cfg_bf,
                                                     multi_thread=False),
                                    enc_sd, dec_sd, preprocess_cfg=pre,
                                    device="cuda")
        extract_bf, out_bf = bf16_extract({False: engine, True: engine_bf},
                                          pts, valid)
        cpu_bf = InferenceEngine(config_from_dict(cfg_bf,
                                                  multi_thread=False),
                                 enc_sd, dec_sd, preprocess_cfg=pre,
                                 device="cpu", matmul_policy=precision.BF16)
        extract_bf["cpu_bf16"] = bf16_vs_cpu(torch, tenc, cpu_bf, pts, valid,
                                             out_bf)
        del cpu_bf, out_bf
        # the bf16 path's launches: the accuracy run alone
        kernels.reset_launches()
        cfg_e = copy.deepcopy(acc_cfg)
        cfg_e["tpu"]["encoder_bf16"] = True
        args_e = config_from_dict(cfg_e, multi_thread=False)
        engine_e = InferenceEngine(
            args_e, enc_sd, dec_sd, device="cuda",
            preprocess_cfg=infer.device_preprocess_config(args_e))
        if engine_e.encoder.act_dtype != "bfloat16":
            raise AssertionError("bf16: the option did not reach the encoder")
        out_e = os.path.join(tmp, "out_acc_bf16")
        system_e, log_e, sec_e = run_slam(infer, args_e, engine_e, acc_dir,
                                          out_e)
        sm = slam_summary(system_e, [c for c, _ in log_e], sec_e, out_e,
                          raw[1], max_drop_share=None)
        launches = launches_of(kernels, entries, "bf16", launched)
        require(launches, ("fps", "knn"), "bf16")
        emit(dict(phase="bf16", card=smi, engine=extract_bf,
                  accuracy=dict(
                      frames=ACC_FRAMES, ate_aligned_m=sm["ate_aligned_m"],
                      ate_aligned_f32_m=acc["loops_on"]["ate_aligned_m"],
                      ate_unaligned_m=sm["ate_m"],
                      frames_accepted=sm["frames"] - sm["dropped"],
                      keyframes=sm["keyframes"], loop_edges=sm["loop_edges"],
                      scans_per_s=sm["scans_per_s"],
                      scans_per_s_f32=acc["loops_on"]["scans_per_s"]),
                  train_step=bf16_train_steps(
                      torch, kernels, entries, launched,
                      os.path.join(tmp, TRAIN_YAML), tmp),
                  launches=launches))

        # ---------------------------------------------- CPU comparison
        # float32 on both sides under the float32 gates; then the
        # tpu.bf16 rule on both sides, held by the rule's move from
        # float32 on the card and the CPU's own spread under the rule
        cpu_f32 = InferenceEngine(args_f32, enc_sd, dec_sd,
                                  preprocess_cfg=pre, device="cpu")
        cpu_frames = compare_cpu(cpu_f32, pts, valid, main_f32["frames"])[0]
        cpu_bf = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                                 device="cpu", matmul_policy=precision.BF16)
        cpu_frames_bf, mine = compare_cpu(cpu_bf, pts, valid,
                                          main_out["frames"])
        spread = {}
        for name, witness in (("float64_sums", float64_sums()),
                              ("ulp_nudge", ulp_nudge(SEED))):
            with witness:
                spread[name] = compare_cpu(cpu_bf, pts, valid, mine)[0]
        moves = [relerr(bf[0], fl[0]) for bf, fl in
                 zip(main_out["frames"], main_f32["frames"])][:CPU_FRAMES]
        normals.USE_FUSED_SWEEP = True
        args_af = config_from_dict(CONFIG, multi_thread=False)
        args_af.tpu.sweep_reuse = True
        args_af.tpu.bf16 = False
        logs = {}
        for name, a_c, dev, policy, witness in (
                ("gpu_f32", args_af, "cuda", None, None),
                ("cpu_f32", args_af, "cpu", None, None),
                ("cpu_bf16", args_a, "cpu", precision.BF16, None),
                ("cpu_bf16_float64_sums", args_a, "cpu", precision.BF16,
                 float64_sums()),
                ("cpu_bf16_ulp_nudge", args_a, "cpu", precision.BF16,
                 ulp_nudge(SEED))):
            eng_c = InferenceEngine(a_c, enc_sd, dec_sd, preprocess_cfg=pre_a,
                                    device=dev, matmul_policy=policy)
            kernels.reset_launches()
            with witness or contextlib.nullcontext():
                _, logs[name], _ = run_slam(
                    infer, a_c, eng_c, seq_c,
                    os.path.join(tmp, f"out_c_{name}"))
            launches_of(kernels, entries, f"cpu_phase_{name}", launched)
        normals.USE_FUSED_SWEEP = False
    slam = compare_slam_cpu(logs["cpu_f32"], logs["gpu_f32"])
    slam_bf = compare_slam_cpu(logs["cpu_bf16"], log_a)
    slam_spread = {name: compare_slam_cpu(logs["cpu_bf16"],
                                          logs[f"cpu_bf16_{name}"])
                   for name in spread}
    emit(dict(phase="cpu", card=smi, frames=cpu_frames,
              gates=hold("cpu", cpu_frames, F32_GATES),
              frames_bf16=cpu_frames_bf, rule_vs_f32_desc_relerr=moves,
              cpu_spread_bf16=spread,
              limits_bf16=hold("cpu_bf16", cpu_frames_bf, rule_frame_limits(
                  moves, list(spread.values()))),
              slam=slam, slam_gates=hold("cpu_slam", slam, F32_GATES),
              slam_bf16=slam_bf, slam_cpu_spread_bf16=slam_spread,
              slam_limits_bf16=hold("cpu_slam_bf16", slam_bf, spread_limits(
                  F32_GATES, list(slam_spread.values()))),
              disagreed=DISAGREED))
    if DISAGREED:
        raise AssertionError(f"GPU and CPU disagree: {DISAGREED}")

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
