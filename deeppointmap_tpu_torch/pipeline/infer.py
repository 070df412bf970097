"""Single-agent SLAM inference entry point (port of
deeppointmap_tpu/pipeline/infer.py).

CLI parity with the reference (reference: pipeline/infer.py:35-121):

    python -m deeppointmap_tpu_torch.pipeline.infer --yaml_file cfg.yaml \
        --weight artifacts/full_size_occ_v2/weights_final.msgpack \
        [--device cpu] [--multi_thread] [--profile]

accepts the reference's YAML configs unchanged (yaml overrides CLI) and
writes the same result tree per sequence: a settings.yaml snapshot,
trajectory.{allframes,allsteps,keyframes,keysteps}.txt and the pose graph as
g2o. The engine runs on `cuda` unless `--device` says otherwise.
`multi_thread` runs each sequence through the pipelined SlamSystem;
`tpu.sequence_parallel` > 1 runs several sequences at once, one engine per
GPU (or that many CPU engines with `--device cpu`); `--profile` writes a
torch.profiler Chrome trace under `<infer_tgt>/profile`.

Reader threads overlap file reading and host preprocessing with device
compute (the reference uses torch DataLoader workers, infer.py:98).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from deeppointmap_tpu_torch.config import load_config, save_settings
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
from deeppointmap_tpu_torch.data.transforms import PointCloudTransforms
from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices
from deeppointmap_tpu_torch.pipeline.common import (build_models,
                                                    infer_padding)
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import SlamSystem
from deeppointmap_tpu_torch.utils.timer import device_trace

logger = logging.getLogger("deeppointmap_tpu_torch.infer")

_DEVICE_CHAIN_KEYS = {"VoxelSample", "ToGPU", "ToCPU", "DistanceSample",
                      "OutlierFilter", "LowPassFilter",
                      "CoordinatesNormalization", "ToTensor"}


def device_preprocess_config(args):
    """The device filter chain of the yaml `transforms:` tree, or None when
    the host chain runs it (`tpu.device_preprocess: false`, or a chain with
    other stages than the standard inference chain). With
    `tpu.sweep_reuse` (and the hybrid querier) the sweep is widened so that
    it also serves the encoder's stage-1 grouping."""
    if not args.tpu.get("device_preprocess", True):
        return None
    if not set(dict(args.transforms)) <= _DEVICE_CHAIN_KEYS:
        return None
    sweep_k = 0
    querier = str(args.encoder.get("querier", "hybrid")).lower()
    if args.tpu.get("sweep_reuse", False) \
            and querier in ("hybrid", "hybrid-t3d"):
        # stage-1 group size + self + 8 slack candidates for re-masking
        # filter-dropped points (models/encoder._group_from_sweep)
        sweep_k = int(args.encoder.nsample_list[0][0]) + 9
    return PreprocessConfig.from_transforms(dict(args.transforms),
                                            sweep_k=sweep_k)


def _pad(pts: np.ndarray, pad: int):
    """(n, 3) -> (1, pad, 3) zero-padded (or cut) and validity (1, pad)."""
    padded = np.zeros((pad, 3), np.float32)
    v = np.zeros((pad,), bool)
    n = min(pts.shape[0], pad)
    padded[:n] = pts[:n]
    v[:n] = True
    return padded[None], v[None]


def make_infer_transform(args):
    """Infer-mode preprocessing returning padded fixed-shape arrays: a
    function scan -> (points (1, P, 3), rotation, translation, validity
    (1, P), the original cloud), P = `tpu.encoder_points`.

    Host chain (`device_preprocess_config` is None): the whole transform
    chain runs here (data/transforms.py) and the points come out
    normalized. Device chain: only the voxel downsample runs here; distance
    / outlier / lowpass / normalize run on the device inside the extract
    call (data/preprocess.py), so the points are RAW METERS."""
    pad = infer_padding(args)

    if device_preprocess_config(args) is None:
        tf = PointCloudTransforms(args, mode="infer")

        def run(scan):
            pts, R, T, valid, original = tf(scan)
            if pts.shape[0] != pad:
                pts, valid = _pad(pts, pad)
                return pts, R, T, valid, original
            return pts[None], R, T, valid[None], original

        return run

    vox = dict(args.transforms).get("VoxelSample")

    def run_device(scan):
        original = scan.xyz.copy()
        xyz = scan.xyz
        if vox is not None:
            xyz = xyz[voxel_downsample_indices(
                xyz, vox["voxel_size"], vox.get("retention", "center"))]
        pts, v = _pad(xyz, pad)
        return pts, scan.rotation, scan.translation, v, original

    return run_device


def prefetch(dataset, n_buffer: int = 8, n_workers: int = 4):
    """Parallel order-preserving prefetch: reading and the host
    preprocessing run on a thread pool while the device computes."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(dataset)
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        futures = [pool.submit(dataset.__getitem__, i)
                   for i in range(min(n_buffer, n))]
        for head in range(n):
            item = futures[head].result()
            futures[head] = None  # free memory
            if len(futures) < n:
                futures.append(pool.submit(dataset.__getitem__,
                                           len(futures)))
            yield item


def run_sequence(args, engine, seq_root: str, out_dir: str,
                 system_id: int = 1) -> SlamSystem:
    """One sequence directory through a fresh SlamSystem, frame by frame or
    pipelined (`multi_thread`); writes the trajectory files and the g2o
    pose graph into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    # scan tokens restart at (system_id << 16) every sequence: stale
    # token-keyed device-cache entries from a previous sequence on this
    # engine would otherwise collide (same token, same shapes, wrong data)
    engine.invalidate_device_cache()
    agent = BasicAgent(root=seq_root, reader="auto")
    agent.set_independent(make_infer_transform(args))
    system = SlamSystem(args, engine, system_id=system_id,
                        logger_dir=out_dir)

    if args.get("multi_thread"):
        system.warmup(agent[0])
        t0 = time.perf_counter()
        system.MT_Init()
        for data in prefetch(agent):
            system.MT_Step(data)
        system.MT_Done()
        system.MT_Wait()
    else:
        t0 = time.perf_counter()
        for i, data in enumerate(prefetch(agent)):
            code = system.step(data)
            if (i + 1) % 50 == 0:
                stats = ", ".join(
                    f"{k}:{v[0] * 1000:.1f}ms"
                    for k, v in system.result_logger.log_time(50).items())
                logger.info("frame %d [%s] %s", i, code.name, stats)
    dt = time.perf_counter() - t0
    n = len(agent)
    logger.info("sequence done: %d frames in %.1fs = %.2f scans/s (%s)",
                n, dt, n / max(dt, 1e-9),
                "pipelined" if args.get("multi_thread") else "sequential")

    system.result_logger.save_trajectory("trajectory")
    system.result_logger.save_posegraph("trajectory")
    try:
        system.result_logger.draw_trajectory("trajectory", draft=False)
    except ImportError as e:  # no matplotlib (the card machine has none)
        logger.warning("map render failed: %s", e)
    return system


def _make_engine(args, states, device) -> InferenceEngine:
    return InferenceEngine(args, *states,
                           preprocess_cfg=device_preprocess_config(args),
                           device=device)


def run_inference(args) -> int:
    """What `main` does with a loaded config: load the weights
    (`.msgpack` or the reference's `.pth`) before anything is written,
    snapshot the settings, then run every existing
    sequence of `infer_src` into `infer_tgt/SeqNN`, on one engine or, with
    `tpu.sequence_parallel` > 1, on several at once; under `--profile`,
    inside a profiler trace. -> the number of engines."""
    states = build_models(args, args.weight)
    os.makedirs(args.infer_tgt, exist_ok=True)
    save_settings(args, os.path.join(args.infer_tgt, "settings.yaml"))

    seqs = []
    for i, s in enumerate(args.infer_src):
        if os.path.isdir(s):
            seqs.append((i, s))
        else:
            logger.warning("skip missing sequence dir: %s", s)

    sp = int((args.get("tpu") or {}).get("sequence_parallel", 1) or 1)
    profile_dir = (os.path.join(args.infer_tgt, "profile")
                   if args.get("profile") else None)
    with device_trace(profile_dir, cuda=str(args.device).startswith("cuda")):
        if sp > 1 and len(seqs) > 1:
            return run_sequences_parallel(args, states, seqs, sp)
        engine = _make_engine(args, states, args.device)
        for i, seq in seqs:
            out_dir = os.path.join(args.infer_tgt, f"Seq{i:02d}")
            logger.info("=== sequence %d: %s -> %s", i, seq, out_dir)
            run_sequence(args, engine, seq, out_dir, system_id=1)
        return 1


def run_sequences_parallel(args, states, seqs, n_streams: int) -> int:
    """Several sequences at once: one engine on each CUDA device (capped
    by `n_streams`), or `n_streams` engines with `--device cpu`, each
    running its share of the sequences on a thread of its own, with its
    device current there. An engine's token-keyed device cache must never
    serve two streams at once (scan tokens repeat across sequences), so
    the sequences are partitioned per engine. -> the engine count."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if str(args.device).startswith("cuda"):
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(args.device)] * n_streams
    n = min(n_streams, len(devices))
    engines = [_make_engine(args, states, devices[k]) for k in range(n)]
    logger.info("sequence-parallel: %d streams over %d devices", n,
                len(set(devices)))
    parts = [seqs[k::n] for k in range(n)]

    def worker(k):
        if engines[k].device.type == "cuda":
            torch.cuda.set_device(engines[k].device)
        for i, seq in parts[k]:
            out_dir = os.path.join(args.infer_tgt, f"Seq{i:02d}")
            logger.info("=== sequence %d: %s -> %s (engine %d)", i, seq,
                        out_dir, k)
            run_sequence(args, engines[k], seq, out_dir, system_id=1)

    with ThreadPoolExecutor(max_workers=n) as pool:
        for f in [pool.submit(worker, k) for k in range(n)]:
            f.result()
    return n


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = load_config(argv)
    args.mode = "infer"
    run_inference(args)


if __name__ == "__main__":
    main()
