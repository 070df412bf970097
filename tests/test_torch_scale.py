"""The port's long-stream scale run (deeppointmap_tpu_torch/pipeline/
scale.py, scripts/scale_run_torch.py) against the JAX package's
scripts/scale_run.py on the CPU.

drifting_laps and build_world (with its world_meta.json fingerprint) are
bit-equal to the JAX script's. run_scale is pipelined, and the pipelined
mode is not repeatable in either package: candidate search reads the pose
graph as far as the mapping thread has come, so keyframes, loop attempts
and the trajectory move with thread timing. So run_scale (twice in the
port, once in the JAX package) is held only to what repeats: every frame
streamed, mapped and in the graph, and the summary's keys and blocks. The
decisions and the trajectory are held where they repeat: the same stream
and gates run frame by frame (SEQ_FRAMES, four loop attempts) give the
same keyframes, loop edges and loop funnel in both packages, every pose
within POSE_TOL_M and the aligned ATE within ATE_TOL_M.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import load_weights as jload_weights
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu.utils.evaluation import ate_rmse as jate
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.pipeline import scale
from deeppointmap_tpu_torch.pipeline.common import load_weights
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE_FRAMES, PIPE_BLOCK = 16, 8
SEQ_FRAMES = 24
ATE_TOL_M = 1e-3
#: a frame moves 1.6 m; the two registrations of a frame agree to ~1 cm
#: (float32 sums in another order), and the poses carry that on
POSE_TOL_M = 0.02
POSE_TOL_RAD = 5e-4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JSR = _load("jax_scale_run", os.path.join(REPO, "scripts/scale_run.py"))


def test_drifting_laps_bit_equal():
    got, want = scale.drifting_laps(300), JSR.drifting_laps(300)
    assert len(got) == len(want) == 300
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = scale.drifting_laps(50, frames_per_lap=20, base_radius=10.0,
                              drift=1.0)
    want = JSR.drifting_laps(50, frames_per_lap=20, base_radius=10.0,
                             drift=1.0)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_build_world_bit_equal_and_fingerprint(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    scale.build_world(a, 12)
    JSR.build_world(b, 12)
    agent_a, agent_b = (os.path.join(r, "scene0", "0") for r in (a, b))
    names = sorted(os.listdir(agent_a))
    assert names == sorted(os.listdir(agent_b)) and len(names) == 12
    for name in names:
        za = np.load(os.path.join(agent_a, name))
        zb = np.load(os.path.join(agent_b, name))
        assert za.files == zb.files
        for key in za.files:
            assert np.array_equal(za[key], zb[key]), (name, key)
    meta = [json.load(open(os.path.join(r, "scene0", "world_meta.json")))
            for r in (a, b)]
    assert meta[0] == meta[1] == dict(kind="drifting_laps", frames=12,
                                      max_points=2000)
    # kept while the fingerprint holds, rebuilt when it changes
    stamp = os.path.getmtime(os.path.join(agent_a, "0.npz"))
    scale.build_world(a, 12)
    assert os.path.getmtime(os.path.join(agent_a, "0.npz")) == stamp
    scale.build_world(a, 8)
    assert len(os.listdir(agent_a)) == 8


@pytest.fixture(scope="module")
def pipelined(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scale")
    port = [scale.run_scale(PIPE_FRAMES, PIPE_BLOCK, root=str(tmp / "w"),
                            out=str(tmp / f"o{r}"), quiet=True,
                            device="cpu") for r in range(2)]
    jax_run = JSR.run_scale(PIPE_FRAMES, PIPE_BLOCK, root=str(tmp / "wj"),
                            out=str(tmp / "oj"), quiet=True)
    return port, jax_run


def _repeatable(summary):
    """What a pipelined run repeats whatever the thread timing: the frames
    in the graph and the shape of the record."""
    return dict(frames=summary["frames"],
                retain_nonkeyframe_pcd=summary["retain_nonkeyframe_pcd"],
                blocks=[blk["frames"] for blk in summary["blocks"]],
                finite_ate=bool(np.isfinite(summary["ate_m"])))


def test_run_scale_twice_in_the_port(pipelined):
    """Two pipelined runs account for every frame alike."""
    a, b = pipelined[0]
    assert _repeatable(a) == _repeatable(b) == dict(
        frames=PIPE_FRAMES, retain_nonkeyframe_pcd=False,
        blocks=list(range(PIPE_BLOCK, PIPE_FRAMES + 1, PIPE_BLOCK)),
        finite_ate=True)
    for run in (a, b):
        assert run["frames_streamed"] == PIPE_FRAMES
        assert run["frames_mapped"] == PIPE_FRAMES - 1
    assert set(a) == set(b)


def test_run_scale_against_jax(pipelined):
    port, jax_run = pipelined[0][0], pipelined[1]
    assert _repeatable(port) == _repeatable(jax_run)
    # the JAX summary's keys, and the card's memory beside the RSS
    assert set(port) - set(jax_run) == {
        "frames_streamed", "frames_mapped", "rss_growth_mb",
        "device_first_block_mb", "device_last_block_mb", "device_growth_mb",
        "device_max_mb", "device"}
    assert set(jax_run) <= set(port)
    for blk in port["blocks"]:
        assert set(blk) == {"frames", "scans_per_sec", "rss_mb", "device_mb",
                            "device_max_mb", "keyframes", "loop_edges",
                            "stages_ms"}
        assert blk["device_mb"] is None and blk["rss_mb"] > 0
    assert port["device_growth_mb"] is None and port["device"] == "cpu"


def test_run_scale_asked_for_cuda_without_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scale.run_scale(4, 2, root=str(tmp_path / "w"),
                        out=str(tmp_path / "o"))


@pytest.fixture(scope="module")
def frame_by_frame(tmp_path_factory):
    """scale_args' gates on the drifting laps, run_sequence frame by frame
    in both packages. -> {"port", "jax"}: (system, pred, gt)."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("scale_seq")
    root = str(tmp / "w")
    scale.build_world(root, SEQ_FRAMES)
    args = scale.scale_args(root, str(tmp / "o"))
    engine = InferenceEngine(args, *load_weights(args, scale.WEIGHTS),
                             device="cpu",
                             preprocess_cfg=tinfer.device_preprocess_config(
                                 args))
    port = tinfer.run_sequence(args, engine, args.infer_src[0],
                               str(tmp / "o"))
    jdemo = _load("jax_train_synthetic_demo_scale",
                  os.path.join(REPO, "scripts/train_synthetic_demo.py"))
    jargs = jdemo.demo_args(root, str(tmp / "oj"))
    for key in ("loop_detection_trust_range", "edge_rmse_drop",
                "edge_confidence_drop", "loop_detection_attempt_gap",
                "loop_detection_confidence_acpt_threshold"):
        jargs.slam_system[key] = args.slam_system[key]
    jargs.infer_src = args.infer_src
    jargs.tpu["retain_nonkeyframe_pcd"] = False
    enc, dec, ep, dp = jload_weights(jargs, scale.WEIGHTS)
    jengine = JEngine(jargs, ep, dp, encoder=enc, decoder=dec,
                      preprocess_cfg=jinfer.device_preprocess_config(jargs))
    jax_sys = jinfer.run_sequence(jargs, jengine, jargs.infer_src[0],
                                  str(tmp / "oj"))
    runs = {}
    for name, system in (("port", port), ("jax", jax_sys)):
        scans = sorted(system.posegraph_map.get_all_scans(),
                       key=lambda s: s.timestep)
        runs[name] = (system, np.stack([s.SE3_pred for s in scans]),
                      np.stack([s.SE3_gt for s in scans]))
    return runs


def test_loop_funnel_frame_by_frame_equals_jax(frame_by_frame):
    """The same keyframes, loop edges and loop funnel."""
    port, jax_sys = frame_by_frame["port"][0], frame_by_frame["jax"][0]
    pg, jpg = port.posegraph_map, jax_sys.posegraph_map
    assert pg.all_frame_num == jpg.all_frame_num == SEQ_FRAMES
    assert pg.key_frame_num == jpg.key_frame_num
    assert pg.loop_edge_num == jpg.loop_edge_num
    got, want = port.loop.stats, jax_sys.loop.stats
    assert set(got) == set(want)
    for key in want:
        if key == "best_prob":
            assert abs(got[key] - want[key]) <= 0.01
        else:
            assert got[key] == want[key], key
    assert want["attempts"] >= 3 and want["registered"] >= 1


def test_poses_and_ate_frame_by_frame_equal_jax(frame_by_frame):
    """The same trajectory: every pose within POSE_TOL_M and the aligned
    ATE within ATE_TOL_M of the JAX package's."""
    _, pred, gt = frame_by_frame["port"]
    _, jpred, jgt = frame_by_frame["jax"]
    np.testing.assert_allclose(gt, jgt, atol=1e-6)
    np.testing.assert_allclose(pred[:, :3, 3], jpred[:, :3, 3],
                               atol=POSE_TOL_M)
    np.testing.assert_allclose(pred[:, :3, :3], jpred[:, :3, :3],
                               atol=POSE_TOL_RAD)
    assert abs(ate_rmse(pred, gt, align=True)
               - jate(jpred, jgt, align=True)) <= ATE_TOL_M
