"""The programs of the MFU and roofline report (scripts/mfu_profile_torch.py,
chip_smoke.py's `mfu` phase): each hot program as a zero-argument call
with its count from utils/roofline.py on this run's inputs, and the
chained timing that sets one against the other.

Programs, as the JAX package's scripts/mfu_profile.py: extract
(InferenceEngine._extract_impl), fused odometry (_odometry_impl), register
with the information matrix (_register_info) and one stage-1 training step
(Trainer.train_step). Each is counted under its models' matrix-product
policy (utils/precision.py: the network's products at the bfloat16 rate
under "bfloat16"), which its report row names as `matmul_policy`.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from deeppointmap_tpu_torch.utils import roofline

#: frames a group of the stage-1 step (the S of the JAX report's row)
TRAIN_FRAMES = 2


class Program(NamedTuple):
    """A program of the report: its row name, a zero-argument call, its
    count by component, its own bytes (roofline.io_bytes) and its models'
    matmul policy."""
    name: str
    call: Callable
    parts: Dict[str, roofline.Cost]
    nbytes: int
    policy: str


def scan_counts(pre, points, valid, filtered) -> roofline.ScanCounts:
    """This run's counts for an extraction of raw-meter `points` (B, P, 3)
    with validity `valid` under the device chain `pre`, whose filtered
    validity came out as `filtered`: the distance crop's survivors
    (data/preprocess.preprocess's rule), the in-radius pairs of the
    low-pass filter's sweep over them, and the filters' survivors."""
    from deeppointmap_tpu_torch.ops.neighbors import in_radius_pairs
    from deeppointmap_tpu_torch.ops.normals import dot3

    points, valid = points.float(), valid.bool()
    crop = valid
    if pre.use_distance:
        dist = torch.sqrt(dot3(points, points).double())
        crop = valid & (dist >= pre.min_dis) & (dist <= pre.max_dis)
    in_radius = in_radius_pairs(points, crop, points, pre.normals_radius) \
        if pre.use_lowpass else 0
    per_scan = lambda m: tuple(int(x) for x in m.sum(dim=1).tolist())
    return roofline.ScanCounts(crop_valid=per_scan(crop),
                               in_radius=in_radius,
                               valid=per_scan(filtered.bool()))


def steady_ms(fn, trials: int, device):
    """ms a call of `fn` over a chain of `trials` calls ending in one
    synchronize (scripts/mfu_profile.py's steady_ms), after two warm-up
    calls; None on the CPU, where `fn` runs once and is not timed."""
    if torch.device(device).type != "cuda":
        fn()
        return None
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(trials):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / trials * 1e3


def engine_programs(engine, points: np.ndarray, valid: np.ndarray) -> list:
    """The three engine programs on scans 0 (the candidate) and 1 (the new
    scan) of `points` / `valid` (raw meters: the engine runs the device
    chain), as Programs: the counts come from one run of each on these
    inputs, whose tensors give each program's bytes."""
    from deeppointmap_tpu_torch.models.decoder import num_pairs_for

    args, pre = engine.args, engine.preprocess_cfg
    policy = engine.decoder.matmul_policy
    if pre is None:
        raise ValueError("engine_programs takes an engine with the device "
                         "chain (raw-meter scans)")
    tokens = engine.n_tokens
    npairs = num_pairs_for(tokens, tokens, 0.5)
    with torch.inference_mode():
        pd = engine._put(np.ascontiguousarray(points[1:2], np.float32))
        vd = engine._put(np.ascontiguousarray(valid[1:2]))
        c_pts = engine._put(np.ascontiguousarray(points[:1], np.float32))
        c_valid = engine._put(np.ascontiguousarray(valid[:1]))
        cd, cv, cpv = engine._extract_impl(c_pts, c_valid)
        extracted = engine._extract_impl(pd, vd)
        desc, dvalid, pv = extracted
        counts = scan_counts(pre, pd, vd, pv)
    n_pad = points.shape[1]
    cand = (cd[0], cv[0], c_pts[0], cpv[0])
    new = (desc[0], dvalid[0], pd[0], pv[0])

    def extract():
        return engine._extract_impl(pd, vd)

    def odometry():
        return engine._odometry_impl(pd, vd, cd[0], cv[0], c_pts[0], cpv[0],
                                     npairs, npairs)

    def register():
        return engine._register_info(cd[0], cv[0], desc[0], dvalid[0],
                                     c_pts[0], cpv[0], pd[0], pv[0],
                                     npairs, npairs)

    with torch.inference_mode():
        odometry_out, register_out = odometry(), register()
    io = roofline.io_bytes
    return [
        Program("extract (preprocess+encoder)", extract,
                roofline.extract_cost(args, n_pad, counts, pre, policy),
                io(pd, vd, engine.encoder, extracted), policy),
        Program("fused odometry (extract+reg+info)", odometry,
                roofline.odometry_cost(args, n_pad, counts, tokens, npairs,
                                       pre, policy),
                io(pd, vd, cand, engine.encoder, engine.decoder,
                   odometry_out), policy),
        Program(f"register {tokens}v{tokens} (+info)", register,
                roofline.register_cost(args, tokens, n_pad, counts.valid[0],
                                       npairs, policy),
                io(cand, new, engine.decoder, register_out), policy),
    ]


def stage1_batch(args, dataset, pad_to: int):
    """One stage-1 host batch of TRAIN_FRAMES frames a group, from the
    dataset's first item."""
    from deeppointmap_tpu_torch.pipeline.batching import \
        build_registration_batch

    rng = np.random.default_rng(0)
    dataset.forced_S = TRAIN_FRAMES
    try:
        frames, info = dataset[0]
    finally:
        dataset.forced_S = None
    return build_registration_batch(frames, info, args.train.registration,
                                    pad_to, rng)


def train_program(trainer, args, batch) -> Program:
    """One stage-1 step of `trainer` on `batch` as a Program: each call is
    an optimizer step, so the chain is dependent. Takes one step first, so
    that the optimizer's state exists to be counted: the step reads the
    batch, the weights and the optimizer's state once and writes the
    trained weights and the state once."""
    b, s, p = batch.valid.shape
    policy = trainer.decoder.matmul_policy
    parts = roofline.train_step_cost(
        args, b, s, p, [int(v) for v in batch.valid.reshape(b * s, p)
                        .sum(axis=1)],
        int(args.train.registration.get("max_pairs", 1024)), policy)
    metrics = trainer.train_step(batch)
    trained = [q for g in trainer.optimizer.param_groups for q in g["params"]]
    state = roofline.io_bytes(trainer.optimizer.state)
    nbytes = roofline.io_bytes(batch, trainer.encoder, trainer.decoder,
                               trained, metrics) + 2 * state
    return Program(f"stage-1 train step (S={s}, b={b})",
                   lambda: trainer.train_step(batch), parts, nbytes, policy)


def measure(programs, trials: int, device, peaks, card) -> list:
    """Report rows of Programs: each timed by steady_ms (on a card) and
    set against `peaks`, with its `matmul_policy`."""
    return [dict(roofline.report_row(p.name, p.parts, p.nbytes,
                                     steady_ms(p.call, trials, device),
                                     peaks, card), matmul_policy=p.policy)
            for p in programs]
