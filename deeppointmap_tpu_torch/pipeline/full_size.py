"""The full-size training recipe: DeepPointMap-B trained from scratch on
synthetic worlds through both curriculum stages, then evaluated as a whole
SLAM system around a held-out two-lap loop (the port's counterpart of
scripts/train_full_size.py, function by function; the CLI over it is
scripts/train_full_size_torch.py, and chip_smoke.py takes its train scene
and evaluation arguments from here).

The architecture is the one the reference ships for SemanticKITTI
(configs/infer/sample.yaml: npoint 4096/1024/256/64/16, width 16..512, 256
tokens x 128-d descriptors, 3 attention layers), at the 16384-point pad.
Training data: six dense synthetic worlds (distinct seeds) with circle
trajectories of varying radius, 96 frames each; the evaluation world (seed
0, two laps) is never trained on. Worlds are fingerprinted with their
generation settings (`world_meta.json` in the scene directory), so a
changed setting regenerates them and an unchanged one is reused.

Settings are module-level dicts that `apply_artifact_render` and
`apply_occlusion_recipe` update in place; they always start as copies of
the defaults.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time

import numpy as np
import torch

from deeppointmap_tpu_torch.config import config_from_dict

logger = logging.getLogger(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: training scenes: (world seed, circle radius m, direction); 96 frames
#: each. Distinct seeds give distinct geometry; -1 drives the lap in
#: reverse (heading variety). The evaluation world is seed 0, never trained.
TRAIN_SCENES = [(1, 20.0, +1), (2, 28.0, +1), (3, 35.0, +1),
                (4, 24.0, -1), (5, 31.0, -1), (6, 18.0, -1)]
FRAMES_PER_SCENE = 96
#: world + render + evaluation-trajectory settings. The default (compact,
#: un-occluded) recipe: extent-60 worlds where every 45 m scan sees most of
#: the world -- strong registration training, but stage 2's overlap label
#: carries little signal there (far pairs still overlap).
DEFAULT_WORLD = dict(n_clusters=300, extent=60.0, pts_per_cluster=800)
DEFAULT_RENDER = dict(sensor_range=45.0, max_points=16384)
DEFAULT_EVAL = dict(radius=25.0, frames_per_lap=48)
#: the active settings (apply_artifact_render / --occlusion update them)
WORLD = dict(DEFAULT_WORLD)
RENDER = dict(DEFAULT_RENDER)
EVAL_WORLD = dict(DEFAULT_EVAL)
#: --occlusion, the loop-head recipe: first-return spherical z-buffer
#: rendering (data/synthetic.py) makes visibility depend on the viewpoint,
#: and large worlds (extent 120, trajectory radius 42-65 m) make the
#: trajectory's diameter exceed twice the 45 m sensor range, so far pairs
#: of one world truly disjoin. The occluded task is harder for stage 1:
#: warm-start from a trained model (--init_weights) and train --epochs1 24
#: --epochs2 8.
OCCLUSION_RENDER = dict(occlusion_bins=512)
OCCLUSION_WORLD = dict(n_clusters=1200, extent=120.0, pts_per_cluster=800)
OCCLUSION_EVAL = dict(radius=50.0, frames_per_lap=96)
OCCLUSION_SCENES = [(1, 45.0, +1), (2, 55.0, +1), (3, 65.0, +1),
                    (4, 50.0, -1), (5, 60.0, -1), (6, 42.0, -1)]

TRANSFORMS = {
    "VoxelSample": {"voxel_size": 0.3, "retention": "first"},
    "DistanceSample": {"min_dis": 0.0, "max_dis": 60.0},
    "CoordinatesNormalization": {"ratio": 60.0},
    "ToTensor": {"padding_to": -1},
}


def apply_occlusion_recipe() -> None:
    global TRAIN_SCENES
    RENDER.update(OCCLUSION_RENDER)
    WORLD.clear()
    WORLD.update(OCCLUSION_WORLD)
    EVAL_WORLD.clear()
    EVAL_WORLD.update(OCCLUSION_EVAL)
    TRAIN_SCENES = list(OCCLUSION_SCENES)


def _scene_is_current(agent_dir: str, meta: dict) -> bool:
    """The stamp lives in the scene directory: datasets enumerate only
    its subdirectories, and a non-npz file inside the agent directory
    would break the agent's scan enumeration."""
    scene_dir = os.path.dirname(agent_dir)
    try:
        with open(os.path.join(scene_dir, "world_meta.json")) as f:
            return json.load(f) == meta and os.path.isdir(agent_dir)
    except (OSError, ValueError):
        return False


def _stamp_scene(agent_dir: str, meta: dict) -> None:
    with open(os.path.join(os.path.dirname(agent_dir),
                           "world_meta.json"), "w") as f:
        json.dump(meta, f)


def build_training_worlds(root: str, frames: int = FRAMES_PER_SCENE):
    """Dense production-scale worlds (~16k-point scans after rendering),
    one npz scene per entry of TRAIN_SCENES; current ones are kept."""
    from deeppointmap_tpu_torch.data.synthetic import (circle_trajectory,
                                                       make_world,
                                                       write_npz_sequence)

    for si, (seed, radius, direction) in enumerate(TRAIN_SCENES):
        agent = os.path.join(f"scene{si}", "0")
        agent_dir = os.path.join(root, agent)
        meta = dict(seed=seed, radius=radius, direction=direction,
                    frames=frames, **WORLD, **RENDER)
        if _scene_is_current(agent_dir, meta):
            continue
        # the whole scene directory: a stale frame_dis.npy beside the agent
        # would otherwise survive with wrong distances
        shutil.rmtree(os.path.dirname(agent_dir), ignore_errors=True)
        rng = np.random.default_rng(seed)
        world = make_world(rng, **WORLD)
        poses = circle_trajectory(frames, radius=radius)
        if direction < 0:
            poses = poses[::-1]
        write_npz_sequence(root, world, poses, rng=rng, agent=agent,
                           **RENDER)
        _stamp_scene(agent_dir, meta)
        logger.info("scene%d: world seed %d, radius %s m, dir %d, %d frames",
                    si, seed, radius, direction, frames)


def build_eval_world(root: str, laps: int = 2):
    """The two-lap evaluation world (seed 0) at full scan density; radius
    and frames a lap come from EVAL_WORLD."""
    from deeppointmap_tpu_torch.data.synthetic import (circle_trajectory,
                                                       make_world,
                                                       write_npz_sequence)

    agent_dir = os.path.join(root, "scene0", "0")
    meta = dict(seed=0, laps=laps, **EVAL_WORLD, **WORLD, **RENDER)
    if _scene_is_current(agent_dir, meta):
        return
    shutil.rmtree(os.path.dirname(agent_dir), ignore_errors=True)
    rng = np.random.default_rng(0)
    world = make_world(rng, **WORLD)
    lap = circle_trajectory(EVAL_WORLD["frames_per_lap"],
                            radius=EVAL_WORLD["radius"])
    write_npz_sequence(root, world, lap * laps, rng=rng, **RENDER)
    _stamp_scene(agent_dir, meta)


def apply_artifact_render(weights: str) -> None:
    """Adopt the render, world and evaluation settings the weights were
    trained with (render_meta.json beside them). Always resets to the
    defaults first, so weights without the file never inherit an earlier
    model's settings in the same process."""
    RENDER.clear()
    RENDER.update(DEFAULT_RENDER)
    WORLD.clear()
    WORLD.update(DEFAULT_WORLD)
    EVAL_WORLD.clear()
    EVAL_WORLD.update(DEFAULT_EVAL)
    meta_path = os.path.join(os.path.dirname(weights), "render_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if "render" in meta:          # render + world + evaluation geometry
            RENDER.update(meta["render"])
            WORLD.update(meta.get("world", {}))
            EVAL_WORLD.update(meta.get("eval", {}))
        else:                          # the older flat render-only form
            RENDER.update(meta)


def save_render_meta(weights_out: str) -> None:
    os.makedirs(os.path.dirname(weights_out), exist_ok=True)
    with open(os.path.join(os.path.dirname(weights_out),
                           "render_meta.json"), "w") as f:
        json.dump({"render": RENDER, "world": WORLD, "eval": EVAL_WORLD}, f)


def _model_trees():
    """The DeepPointMap-B trees of configs/infer/sample.yaml."""
    from deeppointmap_tpu_torch.config import config_from_yaml

    base = config_from_yaml(os.path.join(REPO, "configs/infer/sample.yaml"))
    return base.encoder, base.decoder


def full_train_args(root: str, out_dir: str, epochs1: int = 12,
                    epochs2: int = 4, remat: bool = False):
    """Stage 1: AdamW 1e-3, cosine to 1e-5, K 2 -> 4 every 4 epochs, one
    item a step; stage 2: Adam 1e-3, cosine, four pairs a step."""
    enc_tree, dec_tree = _model_trees()
    return config_from_dict(dict(
        dataset=[dict(name="synthetic_full", root=root,
                      scenes=[f"scene{i}" for i in range(len(TRAIN_SCENES))],
                      reader=dict(type="npz"))],
        transforms=dict(TRANSFORMS),
        encoder=enc_tree, decoder=dec_tree,
        loss=dict(tau=0.1, offset_value="euclidean", eps_positive=1.0,
                  eps_offset=2.0, lambda_p=1.0, lambda_c=1.0, lambda_o=1.0),
        slam_system=dict(coor_scale=60),
        train=dict(
            auto_cast=False, save_cycle=4, log_cycle=25,
            registration=dict(num_epochs=epochs1, batch_size=1, K=2,
                              K_0=2, K_mult=2, mult_epoch=4, K_max=4,
                              fill=True, distance=10.0, map_size_max=3,
                              max_pairs=1024,
                              optimizer=dict(type="adamw",
                                             kwargs=dict(lr=1e-3)),
                              scheduler=dict(type="cosine",
                                             kwargs=dict(eta_min=1e-5))),
            loop_detection=dict(num_epochs=epochs2, batch_size=4,
                                distance=10.0,
                                optimizer=dict(type="adam",
                                               kwargs=dict(lr=1e-3)),
                                scheduler=dict(type="cosine",
                                               kwargs=dict(eta_min=1e-5)))),
        # the recipe keeps float32 feature activations
        tpu=dict(remat=remat, encoder_bf16=False),
        infer_tgt=out_dir, weight="", checkpoint="", multi_thread=False,
        num_workers=2, profile=False))


def full_eval_args(root: str, out_dir: str):
    """Full-size SLAM on the synthetic two-lap world: the model trees plus
    SLAM thresholds calibrated to the synthetic world (its scan overlap
    differs from KITTI's)."""
    enc_tree, dec_tree = _model_trees()
    return config_from_dict(dict(
        dataset=[dict(name="synthetic_full_eval", root=root,
                      scenes=["scene0"], reader=dict(type="npz"))],
        transforms=dict(TRANSFORMS),
        encoder=enc_tree, decoder=dec_tree,
        loss=dict(tau=0.1, offset_value="euclidean", eps_positive=1.0,
                  eps_offset=2.0, lambda_p=1.0, lambda_c=1.0, lambda_o=1.0),
        slam_system=dict(
            coor_scale=60,
            odometer_candidates_num=1, registration_sample_odometer=0.5,
            # gates for the robust solve's coverage-scaled rmse
            # (ops/kabsch.ransac_kabsch): good solves read rmse ~0.4-0.5,
            # failures 2 or more; the keyframe EMA then keeps 2-3 m spacing
            edge_confidence_drop=0.3, edge_rmse_drop=1.0,
            max_continuous_drop_scan=5,
            continuous_drop_scan_strategy="recover",
            key_frame_distance="auto", key_frame_distance_0=4.0,
            enable_s2m_adjust=True, registration_sample_mapping=0.5,
            enable_loop_closure=True, loop_detection_gap=0,
            loop_detection_transaction_gap=10.0,
            # the reference's production value; trust2 = 30 keyframes stays
            # below the ~40-keyframe lap, so same-heading revisits can pass
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
        # the robust RANSAC solve: confident outliers of the occluded
        # worlds defeat the trimmed solve
        tpu={"robust_register": True},
        infer_src=[os.path.join(root, "scene0", "0")],
        infer_tgt=out_dir, weight="", checkpoint="", multi_thread=False,
        num_workers=2, profile=False))


def _build_trainer(args, seed=0, init_weights: str = "", device="cuda"):
    """-> (Trainer, dataset): one np.random.Generator from `seed` drives
    the transforms, the sampler and the trainer; the models start from a
    fixed random init (seed 0) or from `init_weights`."""
    from deeppointmap_tpu_torch.data.dataset import SlamDatasets
    from deeppointmap_tpu_torch.pipeline.common import (init_params,
                                                        load_weights)
    from deeppointmap_tpu_torch.pipeline.train import training_transforms
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    rng = np.random.default_rng(seed)
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    if init_weights:
        # warm start (the occlusion fine-tune)
        enc_sd, dec_sd = load_weights(args, init_weights)
    else:
        enc_sd, dec_sd = init_params(args, torch.Generator().manual_seed(0))
    trainer = Trainer(args, ds, enc_sd, dec_sd, rng=rng, device=device)
    return trainer, ds


def measure_remat(root: str, out: str, n_steps: int = 10,
                  device="cuda") -> dict:
    """Seconds a stage-1 step of the full-size recipe, remat off and on
    (after one warm-up step)."""
    results = {}
    for remat in (False, True):
        args = full_train_args(root, out, remat=remat)
        trainer, _ = _build_trainer(args, device=device)
        trainer._steps_per_epoch = lambda: n_steps + 2
        trainer._setup_stage()
        it = trainer._iter_batches()
        trainer.train_step(next(it))
        t0 = time.time()
        for _ in range(n_steps):
            trainer.train_step(next(it))
        dt = (time.time() - t0) / n_steps
        trainer.close()
        results[f"remat_{'on' if remat else 'off'}"] = dict(
            sec_per_step=round(dt, 3), steps_per_sec=round(1.0 / dt, 3))
        logger.info("remat=%s: %.3f s/step", remat, dt)
    return results


def evaluate(weights: str, out: str, eval_root: str,
             tpu_overrides: dict | None = None, device="cuda") -> dict:
    """Two-lap SLAM with the weights (`.msgpack` or the reference's
    `.pth`), loops on and off. -> the JAX script's keys (aligned ATE
    `ate_m` / `ate_no_loop_m`, rounded to 0.1 mm, and `loop_edges`), and
    under `runs` each run's unrounded aligned and unaligned ATE, frames
    in the graph, keyframes, loop edges, seconds and its output directory
    (`out`/loops_on, `out`/loops_off)."""
    from deeppointmap_tpu_torch.pipeline.common import load_weights
    from deeppointmap_tpu_torch.pipeline.infer import (
        device_preprocess_config, run_sequence)
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine
    from deeppointmap_tpu_torch.utils.evaluation import ate_rmse

    apply_artifact_render(weights)
    build_eval_world(eval_root)
    out_d, runs = {}, {}
    for name, loops in (("ate_m", True), ("ate_no_loop_m", False)):
        args = full_eval_args(eval_root, out)
        for k, v in (tpu_overrides or {}).items():
            args.tpu[k] = v
        args.slam_system.enable_loop_closure = loops
        args.slam_system.enable_global_optimization = loops
        enc_sd, dec_sd = load_weights(args, weights)
        engine = InferenceEngine(args, enc_sd, dec_sd, device=device,
                                 preprocess_cfg=device_preprocess_config(args))
        run_dir = os.path.join(out, "loops_on" if loops else "loops_off")
        t0 = time.time()
        system = run_sequence(args, engine, args.infer_src[0], run_dir,
                              system_id=1)
        seconds = time.time() - t0
        pg = system.posegraph_map
        scans = sorted(pg.get_all_scans(), key=lambda s: s.timestep)
        pred = np.stack([s.SE3_pred for s in scans])
        gt = np.stack([s.SE3_gt for s in scans])
        aligned = float(ate_rmse(pred, gt, align=True))
        out_d[name] = round(aligned, 4)
        loop_edges = int(pg.loop_edge_num)
        if loops:
            out_d["loop_edges"] = loop_edges
        runs["loops_on" if loops else "loops_off"] = dict(
            ate_aligned_m=aligned,
            ate_unaligned_m=float(ate_rmse(pred, gt, align=False)),
            frames_in_graph=len(scans), keyframes=int(pg.key_frame_num),
            loop_edges=loop_edges, seconds=seconds, out_dir=run_dir)
        logger.info("eval loops=%s: ATE %s m, %d keyframes, %.0fs", loops,
                    out_d[name], pg.key_frame_num, seconds)
    out_d["runs"] = runs
    return out_d
