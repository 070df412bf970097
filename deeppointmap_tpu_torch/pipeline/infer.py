"""Single-agent SLAM inference entry point (port of
deeppointmap_tpu/pipeline/infer.py).

CLI parity with the reference (reference: pipeline/infer.py:35-121):

    python -m deeppointmap_tpu_torch.pipeline.infer --yaml_file cfg.yaml \
        --weight artifacts/full_size_occ_v2/weights_final.msgpack \
        [--device cpu]

accepts the reference's YAML configs unchanged (yaml overrides CLI) and
writes the same result tree per sequence: a settings.yaml snapshot,
trajectory.{allframes,allsteps,keyframes,keysteps}.txt and the pose graph as
g2o. The engine runs on `cuda` unless `--device` says otherwise.

Reader threads overlap file reading and the host voxel downsample with
device compute (the reference uses torch DataLoader workers, infer.py:98);
every CUDA call stays on the caller's thread.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from deeppointmap_tpu_torch.config import load_config, save_settings
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices
from deeppointmap_tpu_torch.pipeline.common import (build_models,
                                                    infer_padding)
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import SlamSystem

logger = logging.getLogger("deeppointmap_tpu_torch.infer")

_DEVICE_CHAIN_KEYS = {"VoxelSample", "ToGPU", "ToCPU", "DistanceSample",
                      "OutlierFilter", "LowPassFilter",
                      "CoordinatesNormalization", "ToTensor"}


def device_preprocess_config(args) -> PreprocessConfig:
    """The device filter chain of the yaml `transforms:` tree. With
    `tpu.sweep_reuse` (and the hybrid querier) the sweep is widened so that
    it also serves the encoder's stage-1 grouping. The host transform chain
    is not ported yet: `tpu.device_preprocess: false`, or a chain with other
    stages than the standard inference chain, is refused."""
    if not args.tpu.get("device_preprocess", True):
        raise NotImplementedError(
            "tpu.device_preprocess: false needs the host transform chain "
            "(data/transforms.py), which is not ported yet")
    extra = set(dict(args.transforms)) - _DEVICE_CHAIN_KEYS
    if extra:
        raise NotImplementedError(
            f"transforms {sorted(extra)} need the host transform chain "
            "(data/transforms.py), which is not ported yet")
    sweep_k = 0
    querier = str(args.encoder.get("querier", "hybrid")).lower()
    if args.tpu.get("sweep_reuse", False) \
            and querier in ("hybrid", "hybrid-t3d"):
        # stage-1 group size + self + 8 slack candidates for re-masking
        # filter-dropped points (models/encoder._group_from_sweep)
        sweep_k = int(args.encoder.nsample_list[0][0]) + 9
    return PreprocessConfig.from_transforms(dict(args.transforms),
                                            sweep_k=sweep_k)


def make_infer_transform(args):
    """Infer-mode host preprocessing: only the voxel downsample runs here;
    distance / outlier / lowpass / normalize run on the device inside the
    extract call (data/preprocess.py). Returns a function scan ->
    (RAW-METER points (1, P, 3) padded to `tpu.encoder_points`, rotation,
    translation, validity (1, P), the original cloud)."""
    pad = infer_padding(args)
    device_preprocess_config(args)      # refuses what needs the host chain
    vox = dict(args.transforms).get("VoxelSample")

    def run_device(scan):
        original = scan.xyz.copy()
        xyz = scan.xyz
        if vox is not None:
            xyz = xyz[voxel_downsample_indices(
                xyz, vox["voxel_size"], vox.get("retention", "center"))]
        padded = np.zeros((pad, 3), np.float32)
        v = np.zeros((pad,), bool)
        n = min(xyz.shape[0], pad)
        padded[:n] = xyz[:n]
        v[:n] = True
        return padded[None], scan.rotation, scan.translation, v[None], \
            original

    return run_device


def prefetch(dataset, n_buffer: int = 8, n_workers: int = 4):
    """Parallel order-preserving prefetch: reading and the host voxel
    downsample run on a thread pool while the device computes."""
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


def _refuse_unported(args) -> None:
    """Raise, before anything is loaded or written, for the modes that are
    not ported yet."""
    if args.get("multi_thread"):
        raise NotImplementedError(
            "multi_thread: the threaded pipeline (SlamSystem.MT_*) is not "
            "ported yet")
    device_preprocess_config(args)


def run_sequence(args, engine, seq_root: str, out_dir: str,
                 system_id: int = 1) -> SlamSystem:
    """One sequence directory through a fresh SlamSystem, frame by frame;
    writes the trajectory files and the g2o pose graph into `out_dir`."""
    _refuse_unported(args)
    os.makedirs(out_dir, exist_ok=True)
    # scan tokens restart at (system_id << 16) every sequence: stale
    # token-keyed device-cache entries from a previous sequence on this
    # engine would otherwise collide (same token, same shapes, wrong data)
    engine.invalidate_device_cache()
    agent = BasicAgent(root=seq_root, reader="auto")
    agent.set_independent(make_infer_transform(args))
    system = SlamSystem(args, engine, system_id=system_id,
                        logger_dir=out_dir)

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
    logger.info("sequence done: %d frames in %.1fs = %.2f scans/s",
                n, dt, n / max(dt, 1e-9))

    system.result_logger.save_trajectory("trajectory")
    system.result_logger.save_posegraph("trajectory")
    try:
        system.result_logger.draw_trajectory("trajectory", draft=False)
    except Exception as e:  # rendering must never kill a finished run
        logger.warning("map render failed: %s", e)
    return system


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = load_config(argv)
    args.mode = "infer"
    _refuse_unported(args)

    enc_state, dec_state = build_models(args, args.weight)
    os.makedirs(args.infer_tgt, exist_ok=True)
    save_settings(args, os.path.join(args.infer_tgt, "settings.yaml"))

    engine = InferenceEngine(args, enc_state, dec_state,
                             preprocess_cfg=device_preprocess_config(args),
                             device=args.device)
    for i, seq in enumerate(args.infer_src):
        if not os.path.isdir(seq):
            logger.warning("skip missing sequence dir: %s", seq)
            continue
        out_dir = os.path.join(args.infer_tgt, f"Seq{i:02d}")
        logger.info("=== sequence %d: %s -> %s", i, seq, out_dir)
        run_sequence(args, engine, seq, out_dir, system_id=1)


if __name__ == "__main__":
    main()
