"""The pipelined SlamSystem (`multi_thread`) of the port on the CPU.

The staleness helpers are held to the JAX package's on the same recorded
pose sequences (1e-9). The pipeline itself is not reproducible frame for
frame (candidate staleness depends on timing), so, as the JAX package's
own tests/test_mt_long_stream.py does, it is compared with the sequential
mode by statistics: on a gentle stream (~1.6 m a frame, the committed
artifacts/synthetic_demo weights) every frame is kept, the ATE stays
within 4x the sequential one (floor 0.1 m) and the staleness fallback never
fires; on a harsh stream (~3.3 m a frame) it fires. A crashed stage makes
MT_Wait raise, naming the stage, instead of hanging.
"""

import os
import threading

import numpy as np
import pytest
import torch

from deeppointmap_tpu.slam.system import SlamSystem as JSlam
from deeppointmap_tpu.utils.evaluation import ate_rmse
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data import synthetic as syn
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
from deeppointmap_tpu_torch.pipeline import infer
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import SlamSystem
from deeppointmap_tpu_torch.utils import se3 as se3m
from tests.test_torch_slam import jax_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "artifacts", "synthetic_demo",
                       "weights_final.msgpack")
#: seconds a pipelined run may take before the test calls it hung
JOIN_S = 240


def demo_config(root: str, out: str) -> dict:
    """scripts/train_synthetic_demo.demo_args as a dict (the model of the
    synthetic_demo weights), loop closure and global optimization off, as
    in tests/test_mt_long_stream.py."""
    return dict(
        infer_src=[root], infer_tgt=out, multi_thread=False, weight="",
        transforms={"DistanceSample": {"min_dis": 0.0, "max_dis": 60.0},
                    "CoordinatesNormalization": {"ratio": 60.0},
                    "ToTensor": {"padding_to": -1}},
        encoder=dict(npoint=[512, 128, 64, 16],
                     radius_list=[[0.03, 0.06], [0.06, 0.12], [0.12, 0.25],
                                  [0.25, 0.5]],
                     nsample_list=[[16, 16], [16, 16], [16, 16], [8, 8]],
                     in_channel=3, out_channel=64, width=16, expansion=4,
                     upsample_layers=2, sample=[{"type": "fps"}] * 4,
                     norm="LN", bias=True),
        decoder=dict(in_channel=64, model_channel=128, attention_layers=2),
        loss=dict(tau=0.1, eps_offset=2.0),
        slam_system=dict(
            coor_scale=60, odometer_candidates_num=1,
            registration_sample_odometer=0.5, edge_confidence_drop=0.0,
            edge_rmse_drop=5.0, max_continuous_drop_scan=5,
            continuous_drop_scan_strategy="recover",
            key_frame_distance="auto", key_frame_distance_0=4.0,
            enable_s2m_adjust=True, registration_sample_mapping=0.5,
            enable_loop_closure=False, loop_detection_gap=0,
            loop_detection_transaction_gap=10.0,
            loop_detection_trust_range=3, loop_detection_gnss_distance=-1,
            loop_detection_pred_distance=100.0,
            loop_detection_rotation_min=30.0,
            loop_detection_translation_min=10.0,
            loop_detection_prob_acpt_threshold=0.6,
            loop_detection_candidates_num=1, registration_sample_loop=0.5,
            loop_detection_confidence_acpt_threshold=0.3,
            enable_global_optimization=False, global_optimization_gap=0),
        tpu=dict(encoder_points=2048, reg_buckets=[128, 256, 512, 1024],
                 loop_batch_buckets=[1, 4, 16, 64], extract_chunk=4))


def write_world(root: str, n_frames: int, frames_per_lap: int) -> None:
    """The synthetic world of tests/test_mt_long_stream.py as KITTI .bin
    files: `n_frames` scans of 2000 points along a 25 m circle of
    `frames_per_lap` frames, with the ground-truth poses beside them."""
    rng = np.random.default_rng(0)
    world = syn.make_world(rng)
    poses = syn.circle_trajectory(frames_per_lap, radius=25.0)[:n_frames]
    os.makedirs(root, exist_ok=True)
    for i, pose in enumerate(poses):
        xyz = syn.render_scan(world, pose, rng=rng, max_points=2000)
        np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)],
                       1).astype(np.float32).tofile(
            os.path.join(root, f"{i:06d}.bin"))
    np.save(os.path.join(root, "..", os.path.basename(root) + "_gt.npy"),
            np.stack(poses))


def run(cfg: dict, mt: bool, depth: int = 2):
    """One sequence through a fresh SlamSystem, pipelined or frame by
    frame, MT_Wait bounded by JOIN_S. -> (system, ATE in meters after a
    rigid alignment)."""
    args = config_from_dict(cfg)
    args.tpu.odometer_pipeline_depth = depth
    engine = InferenceEngine(args, *load_msgpack_weights(WEIGHTS),
                             preprocess_cfg=infer.device_preprocess_config(
                                 args), device="cpu")
    root = cfg["infer_src"][0]
    agent = BasicAgent(root=root, reader="auto")
    agent.set_independent(infer.make_infer_transform(args))
    os.makedirs(cfg["infer_tgt"], exist_ok=True)
    system = SlamSystem(args, engine, system_id=1,
                        logger_dir=cfg["infer_tgt"])
    if mt:
        system.MT_Init()
        for i in range(len(agent)):
            system.MT_Step(agent[i])
        system.MT_Done()
        _wait(system)
    else:
        for i in range(len(agent)):
            system.step(agent[i])
    gt_all = np.load(os.path.join(root, "..",
                                  os.path.basename(root) + "_gt.npy"))
    scans = sorted(system.posegraph_map.get_all_scans(),
                   key=lambda s: s.timestep)
    pred = np.stack([s.SE3_pred for s in scans])
    gt = np.stack([gt_all[s.timestep] for s in scans])
    return system, float(ate_rmse(pred, gt, align=True))


def _wait(system) -> None:
    """MT_Wait on a thread of its own, joined with a timeout: a hang fails
    the test instead of stalling the suite; its exception is re-raised."""
    box = {}

    def target():
        try:
            system.MT_Wait()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "MT_Wait hung"
    if "error" in box:
        raise box["error"]


# ------------------------------------------------------ staleness helpers
def _pose(x: float, yaw: float) -> np.ndarray:
    return se3m.se3(np.array([[np.cos(yaw), -np.sin(yaw), 0],
                              [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]),
                    np.array([x, 0.3 * x, 0.0]))


#: (timestep, pose, keyframe distance) as the mapping stage records them:
#: a platform speeding up from 0.5 to 3 m a frame and slowing down again,
#: a gap in the timesteps (a dropped frame), and a disabled distance gate
TRACE = [(0, _pose(0.0, 0.0), 4.0), (1, _pose(0.5, 0.01), 4.0),
         (2, _pose(1.2, 0.03), 4.0), (3, _pose(3.0, 0.05), 4.0),
         (5, _pose(7.5, 0.12), 5.0), (6, _pose(10.5, 0.15), 5.0),
         (7, _pose(12.0, 0.16), 5.0), (8, _pose(12.6, 0.17), 6.0),
         (9, _pose(13.0, 0.17), 6.0), (10, _pose(13.2, 0.18), -1.0),
         (11, _pose(16.5, 0.2), -1.0), (12, _pose(16.7, 0.2), 6.0)]


@pytest.mark.parametrize("depth,frac", [(1, 0.9), (2, 0.9), (2, 0.5),
                                        (3, 0.3)])
def test_staleness_helpers_match_jax(depth, frac):
    """_platform_speed, _update_staleness_mode (hysteresis included) and
    _predict_pose of both packages after every recorded pose."""
    cfg = demo_config("/nonexistent", "/nonexistent")
    t_sys = SlamSystem(config_from_dict(cfg), None, system_id=1,
                       logger_dir="/nonexistent")
    j_sys = JSlam(jax_config(cfg), None, system_id=1,
                  logger_dir="/nonexistent")
    modes = []
    for ts, pose, kfd in TRACE:
        for s in (t_sys, j_sys):
            s._recent_poses.append((ts, pose.copy()))
            s.mapping.current_key_frame_distance = kfd
        ts_, js_ = t_sys._platform_speed(), j_sys._platform_speed()
        assert (ts_ is None) == (js_ is None)
        if js_ is not None:
            assert abs(ts_ - js_) <= 1e-9
        mode = t_sys._update_staleness_mode(depth, frac)
        assert mode == j_sys._update_staleness_mode(depth, frac)
        modes.append(mode)
        for ahead in (1, 2, 5):
            tp = t_sys._predict_pose(ts + ahead)
            jp = j_sys._predict_pose(ts + ahead)
            assert (tp is None) == (jp is None)
            if jp is not None:
                assert np.abs(tp - jp).max() <= 1e-9
        assert t_sys._predict_pose(ts) is None
    assert t_sys._staleness_events == j_sys._staleness_events
    if (depth, frac) == (2, 0.9):
        # ON at 3 m a frame, OFF again once the platform slows down
        assert True in modes and modes[-1] is False


# ------------------------------------------------------------ pipelined
@pytest.fixture(scope="module")
def gentle(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mt_gentle") / "seq")
    write_world(root, n_frames=40, frames_per_lap=96)  # ~1.6 m a frame
    return demo_config(root, str(tmp_path_factory.mktemp("mt_gentle_out")))


def test_mt_mode_close_to_sequential(gentle):
    """The JAX package's rule (tests/test_mt_long_stream.py): the frames
    kept, ATE_mt < 4 max(ATE_seq, 0.1 m), no staleness event."""
    seq_sys, ate_seq = run(gentle, mt=False)
    mt_sys, ate_mt = run(gentle, mt=True)
    n = 40
    assert seq_sys.posegraph_map.all_frame_num >= 0.95 * n
    assert mt_sys.posegraph_map.all_frame_num >= 0.90 * n
    assert ate_seq < 0.5, ate_seq
    assert ate_mt < 4 * max(ate_seq, 0.1), (ate_mt, ate_seq)
    assert mt_sys._staleness_events == 0
    stages = set(mt_sys.result_logger.time_recorder)
    assert {"to_device", "odometer", "mapping"} <= stages


def test_staleness_fallback_fires_on_a_harsh_stream(tmp_path):
    """~3.3 m a frame at depth 2 against a 4 m keyframe distance: the
    odometer serializes against mapping at least once, and the run still
    ends with every frame accounted for."""
    root = str(tmp_path / "seq")
    write_world(root, n_frames=14, frames_per_lap=48)
    system, _ = run(demo_config(root, str(tmp_path / "out")), mt=True)
    assert system._staleness_events >= 1
    accepted = system.posegraph_map.all_frame_num
    assert 0 < accepted <= 14


def test_crashed_stage_raises_and_does_not_hang(gentle, tmp_path):
    """A mapping stage that raises: EXIT drains downstream, the producer
    is never blocked, and MT_Wait raises RuntimeError naming the stage
    (tests/test_multiagent.py's crash test, for the port)."""
    args = config_from_dict(gentle)
    engine = InferenceEngine(args, *load_msgpack_weights(WEIGHTS),
                             preprocess_cfg=infer.device_preprocess_config(
                                 args), device="cpu")
    agent = BasicAgent(root=gentle["infer_src"][0], reader="auto")
    agent.set_independent(infer.make_infer_transform(args))
    system = SlamSystem(args, engine, system_id=9, logger_dir=str(tmp_path))

    def boom(new_scan, odom_edge):
        raise ValueError("injected mapping failure")

    system.mapping.process = boom
    system.MT_Init()
    for i in range(4):
        system.MT_Step(agent[i])
    system.MT_Done()
    with pytest.raises(RuntimeError, match="mapping.*injected"):
        _wait(system)
    assert not any(t.is_alive() for t in system._threads)


# ------------------------------------------- launch counts across threads
def test_launch_counts_are_exact_across_threads(monkeypatch):
    """Kernel.launch from 16 threads at once, through a stub entry point
    (no nvcc here) and a shortened switch interval: every launch is
    counted, in total and by shape, and each ran with its device current
    (the pipelined mode launches K2 from three stage threads at once)."""
    import sys

    from deeppointmap_tpu_torch import kernels

    k = kernels.Kernel("stub", "knn.cu", "dpm_stub", [])
    k._fn = lambda *args: 0
    current = threading.local()
    seen = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            current.device = self.device

        def __exit__(self, *exc):
            current.device = None

    def entry(*args):
        seen.append((current.device, args[0]))
        return 0

    k._fn = entry
    monkeypatch.setattr(kernels, "device_guard", Guard)
    n_threads, per_thread = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            k.launch(i, device=f"cuda:{i % 2}", shape=(i % 3,))
            for _ in range(per_thread)]) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == n_threads * per_thread
    assert sum(k.shapes.values()) == k.launches
    assert k.shapes[(0,)] == per_thread * len(range(0, n_threads, 3))
    assert all(dev == f"cuda:{i % 2}" for dev, i in seen)
    assert len(seen) == k.launches
