"""The demo-width model's recipe: train a small DeepPointMap on a synthetic
world, then run the whole SLAM system with the trained weights around a
closed loop and report the aligned ATE and the loop closures (the port's
counterpart of scripts/train_synthetic_demo.py; the CLI over it is
scripts/train_synthetic_demo_torch.py).

The model is the one of artifacts/synthetic_demo, which the JAX package's
tests, bench and scale run use: 2048 padded points, npoint 512/128/64/16,
64-d descriptors, two attention layers. No data set or checkpoint is
needed: world -> npz scene -> two-stage training (registration, then the
loop head) -> inference -> trajectory metrics.

    python scripts/train_synthetic_demo_torch.py [--steps 400]
        [--loop_steps 150] [--frames 60] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from deeppointmap_tpu_torch.config import config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def demo_args(root: str, out_dir: str):
    """The demo model's Config over the port's `tpu:` defaults, with the
    trees of scripts/train_synthetic_demo.demo_args, `tpu.bf16` included
    (the network's products in bfloat16 on a card, utils/precision.py)."""
    return config_from_dict(dict(
        dataset=[dict(name="synthetic", root=root, scenes=["scene0"],
                      reader=dict(type="npz"))],
        transforms={
            # synthetic scans are <= 35 m (data/synthetic.py sensor_range),
            # so this crop drops nothing; it satisfies the int16 upload
            # guard (max_dis must fit the +-65.5 m quantization range)
            "DistanceSample": {"min_dis": 0.0, "max_dis": 60.0},
            "CoordinatesNormalization": {"ratio": 60.0},
            "ToTensor": {"padding_to": -1},
        },
        encoder=dict(npoint=[512, 128, 64, 16],
                     radius_list=[[0.03, 0.06], [0.06, 0.12],
                                  [0.12, 0.25], [0.25, 0.5]],
                     nsample_list=[[16, 16], [16, 16], [16, 16], [8, 8]],
                     in_channel=3, out_channel=64, width=16, expansion=4,
                     upsample_layers=2, sample=[{"type": "fps"}] * 4,
                     norm="LN", bias=True),
        decoder=dict(in_channel=64, model_channel=128, attention_layers=2),
        loss=dict(tau=0.1, offset_value="euclidean", eps_positive=1.0,
                  eps_offset=2.0, lambda_p=1.0, lambda_c=1.0, lambda_o=1.0),
        slam_system=dict(
            coor_scale=60,
            odometer_candidates_num=1, registration_sample_odometer=0.5,
            edge_confidence_drop=0.0, edge_rmse_drop=5.0,
            max_continuous_drop_scan=5,
            continuous_drop_scan_strategy="recover",
            key_frame_distance="auto", key_frame_distance_0=4.0,
            enable_s2m_adjust=True, registration_sample_mapping=0.5,
            enable_loop_closure=True, loop_detection_gap=0,
            loop_detection_transaction_gap=10.0,
            loop_detection_trust_range=3,
            loop_detection_gnss_distance=-1,
            loop_detection_pred_distance=100.0,
            loop_detection_rotation_min=30.0,
            loop_detection_translation_min=10.0,
            loop_detection_prob_acpt_threshold=0.6,
            loop_detection_candidates_num=1,
            registration_sample_loop=0.5,
            loop_detection_confidence_acpt_threshold=0.3,
            enable_global_optimization=True, global_optimization_gap=0),
        train=dict(
            auto_cast=False, save_cycle=1000, log_cycle=50,
            registration=dict(num_epochs=1, batch_size=1, K=3, K_0=3,
                              K_mult=1, mult_epoch=1000, K_max=6, fill=True,
                              distance=9.0, map_size_max=3, max_pairs=256,
                              optimizer=dict(type="adamw",
                                             kwargs=dict(lr=1e-3)),
                              scheduler=dict(type="cosine",
                                             kwargs=dict(eta_min=1e-5))),
            loop_detection=dict(num_epochs=1, batch_size=4, distance=10.0,
                                optimizer=dict(type="adam",
                                               kwargs=dict(lr=5e-4)),
                                scheduler=dict(type="identity"))),
        tpu=dict(encoder_points=2048, reg_buckets=[128, 256, 512, 1024],
                 loop_batch_buckets=[1, 4, 16, 64], extract_chunk=4,
                 bf16=True),
        infer_src=[os.path.join(root, "scene0", "0")],
        infer_tgt=out_dir, weight="", checkpoint="", multi_thread=False,
        num_workers=2, profile=False))


def _world(frames: int):
    """(rng, the demo world (seed 0, default world settings), its 25 m
    circle of `frames` poses): the draws every demo scan starts from."""
    from deeppointmap_tpu_torch.data.synthetic import (circle_trajectory,
                                                       make_world)

    rng = np.random.default_rng(0)
    return rng, make_world(rng), circle_trajectory(frames, radius=25.0)


def write_world(root: str, frames: int) -> None:
    """The demo world along a 25 m circle of `frames` frames, 2000 points
    a scan, as an npz scene; an existing scene0 is kept, as the JAX script
    keeps it."""
    from deeppointmap_tpu_torch.data.synthetic import write_npz_sequence

    rng, world, poses = _world(frames)
    if not os.path.isdir(os.path.join(root, "scene0")):
        write_npz_sequence(root, world, poses, rng=rng, max_points=2000)
    print(f"world: {world.shape[0]} pts, {frames} frames", flush=True)


def padded_scans(frames: int, n_scans: int, n_pad: int):
    """The first n_scans scans of write_world's world and circle (the same
    draws, rendered in memory), raw meters padded to n_pad: (n_scans,
    n_pad, 3) float32 and validity (n_scans, n_pad)."""
    from deeppointmap_tpu_torch.data.synthetic import render_scan

    rng, world, poses = _world(frames)
    pts = np.zeros((n_scans, n_pad, 3), np.float32)
    valid = np.zeros((n_scans, n_pad), bool)
    for i in range(n_scans):
        xyz = render_scan(world, poses[i], rng=rng, max_points=2000)
        pts[i, :len(xyz)] = xyz
        valid[i, :len(xyz)] = True
    return pts, valid


def train(args, steps: int, loop_steps: int, weights_out: str,
          device: str) -> dict:
    """Both stages from the seeded random init, `steps` / `loop_steps`
    steps a stage; writes the weights as msgpack. -> seconds in all and by
    stage, and the steps of each stage."""
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.data.transforms import PointCloudTransforms
    from deeppointmap_tpu_torch.pipeline.common import (init_params,
                                                        save_weights)
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    trng = np.random.default_rng(1)
    tfs = PointCloudTransforms(args, mode="train", rng=trng)
    tfs.transforms.transforms = tfs.transforms.transforms[:-1]
    ds = SlamDatasets(args, data_transforms=tfs, rng=trng)
    enc_sd, dec_sd = init_params(args, torch.Generator().manual_seed(0))
    trainer = Trainer(args, ds, enc_sd, dec_sd, rng=trng, device=device)
    trainer._steps_per_epoch = lambda: (
        steps if trainer.stage == 1 else loop_steps)
    trainer._setup_stage()
    stage_s = {1: 0.0, 2: 0.0}
    one_epoch = trainer.train_one_epoch

    def timed_epoch():
        t = time.perf_counter()
        one_epoch()
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        stage_s[trainer.stage] += time.perf_counter() - t

    trainer.train_one_epoch = timed_epoch
    t0 = time.perf_counter()
    try:
        trainer.run()
    finally:
        trainer.close()
    train_s = time.perf_counter() - t0
    print(f"training done in {train_s:.0f}s", flush=True)
    save_weights(weights_out, trainer.encoder.state_dict(),
                 trainer.decoder.state_dict())
    return dict(train_s=train_s, stage1_s=stage_s[1], stage2_s=stage_s[2],
                stage1_steps=steps, stage2_steps=loop_steps)


def run_slam(args, weights: str, out_dir: str, device: str) -> dict:
    """The sequence `args.infer_src[0]` through run_sequence with
    `weights` (bench_torch.py's accuracy block runs its two-lap worlds
    through it too). -> frames, keyframes, odometry and loop edges, the
    aligned ATE and the seconds."""
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.pipeline.infer import (
        device_preprocess_config, run_sequence)
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine
    from deeppointmap_tpu_torch.utils.evaluation import ate_rmse

    enc_sd, dec_sd = load_weights(args, weights)
    engine = InferenceEngine(args, enc_sd, dec_sd, device=device,
                             preprocess_cfg=device_preprocess_config(args))
    t0 = time.perf_counter()
    system = run_sequence(args, engine, args.infer_src[0], out_dir,
                          system_id=1)
    seconds = time.perf_counter() - t0
    pg = system.posegraph_map
    scans = sorted(pg.get_all_scans(), key=lambda s: s.timestep)
    pred = np.stack([s.SE3_pred for s in scans])
    gt = np.stack([s.SE3_gt for s in scans])
    return dict(frames=int(pg.all_frame_num), keyframes=int(pg.key_frame_num),
                odom_edges=int(pg.odom_edge_num),
                loop_edges=int(pg.loop_edge_num),
                ate_m=float(ate_rmse(pred, gt, align=True)),
                seconds=seconds)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--loop_steps", type=int, default=150)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--root",
                    default=os.path.join(REPO, "log_infer/synthetic_world"))
    ap.add_argument("--out",
                    default=os.path.join(REPO, "log_infer/synthetic_demo"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Train, save, run SLAM. -> the training and SLAM figures (also
    printed as one JSON line)."""
    from deeppointmap_tpu_torch.pipeline.common import require_device

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ns = build_parser().parse_args(argv)
    device = require_device(ns.device)
    write_world(ns.root, ns.frames)
    os.makedirs(ns.out, exist_ok=True)
    args = demo_args(ns.root, ns.out)
    wpath = os.path.join(ns.out, "weights_final.msgpack")
    res = dict(device=device, train=train(args, ns.steps, ns.loop_steps,
                                          wpath, device), weights=wpath)
    res["slam"] = slam = run_slam(args, wpath, ns.out, device)
    print(f"SLAM: {slam['frames']} frames ({slam['keyframes']} keyframes) "
          f"in {slam['seconds']:.0f}s; odom edges {slam['odom_edges']}, "
          f"loop edges {slam['loop_edges']}", flush=True)
    print(f"ATE RMSE (aligned): {slam['ate_m']:.3f} m over a "
          f"{2 * np.pi * 25:.0f} m loop", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
