"""The port's demo-width recipe (deeppointmap_tpu_torch/pipeline/demo.py,
scripts/train_synthetic_demo_torch.py) against the JAX package's
scripts/train_synthetic_demo.py on the CPU: the same arguments (the `tpu:`
tree on the port's keys), the same world bit for bit, weights from `main`
that the JAX package loads and runs, and the committed
artifacts/synthetic_demo weights taking the same exit codes and keyframes
over the demo world's first SLAM_FRAMES frames in both packages, with the
aligned ATE within ATE_TOL_M and the poses within POSE_TOL_M."""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from deeppointmap_tpu.data import synthetic as jsyn
from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import init_params as jinit_params
from deeppointmap_tpu.pipeline.common import load_weights as jload_weights
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu.utils.evaluation import ate_rmse as jate
from deeppointmap_tpu_torch.models.weights import (flax_tree_from_state_dict,
                                                   load_msgpack_weights)
from deeppointmap_tpu_torch.pipeline import demo
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "artifacts/synthetic_demo/weights_final.msgpack")
#: the recipe's default world
FRAMES = 60
SLAM_FRAMES = 16
ATE_TOL_M = 1e-3
#: the frames are 2.6 m apart; the two registrations of a frame agree to
#: ~3 cm (float32 sums in another order, int16 uploads in both)
POSE_TOL_M = 0.05


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JDEMO = _load("jax_train_synthetic_demo",
              os.path.join(REPO, "scripts/train_synthetic_demo.py"))


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _same_npz_dirs(a: str, b: str) -> int:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        za, zb = np.load(os.path.join(a, name)), np.load(os.path.join(b, name))
        assert za.files == zb.files
        for key in za.files:
            assert za[key].dtype == zb[key].dtype
            assert np.array_equal(za[key], zb[key]), (name, key)
    return len(names)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_demo_args_equal_the_jax_script():
    got, want = demo.demo_args("/w", "/o"), JDEMO.demo_args("/w", "/o")
    assert set(got) == set(want)
    for key in want:
        if key != "tpu":
            assert _plain(got[key]) == _plain(want[key]), key
    for key, value in got.tpu.items():
        assert _plain(value) == _plain(want.tpu[key]), key
    assert got.tpu.encoder_points == 2048 and got.tpu.bf16 is True


def test_world_is_bit_equal_to_the_jax_script(tmp_path):
    """demo.write_world against the JAX script's main (its lines :105-110)
    and its rule: an existing scene is kept."""
    rng = np.random.default_rng(0)
    world = jsyn.make_world(rng)
    poses = jsyn.circle_trajectory(FRAMES, radius=25.0)
    jsyn.write_npz_sequence(str(tmp_path / "jax"), world, poses, rng=rng,
                            max_points=2000)
    demo.write_world(str(tmp_path / "port"), FRAMES)
    n = _same_npz_dirs(str(tmp_path / "jax" / "scene0" / "0"),
                       str(tmp_path / "port" / "scene0" / "0"))
    assert n == FRAMES
    demo.write_world(str(tmp_path / "port"), 8)
    assert len(os.listdir(tmp_path / "port" / "scene0" / "0")) == FRAMES


def test_main_writes_weights_the_jax_package_runs(tmp_path):
    """main at 2 + 1 steps on an 8-frame world, on the CPU: both stages
    step, SLAM runs, and the msgpack loads in the JAX package into the demo
    model's tree (every leaf's shape as JAX's init), with the port's values,
    and extracts finite descriptors there."""
    root, out = str(tmp_path / "world"), str(tmp_path / "out")
    res = demo.main(["--steps", "2", "--loop_steps", "1", "--frames", "8",
                     "--root", root, "--out", out, "--device", "cpu"])
    assert res["train"]["stage1_steps"] == 2
    assert res["train"]["stage2_steps"] == 1
    assert res["train"]["stage1_s"] > 0 and res["train"]["stage2_s"] > 0
    assert res["weights"] == os.path.join(out, "weights_final.msgpack")
    assert 1 <= res["slam"]["frames"] <= 8
    assert np.isfinite(res["slam"]["ate_m"])

    jargs = JDEMO.demo_args(root, out)
    enc, dec, ep, dp = jload_weights(jargs, res["weights"])
    _, _, ep0, dp0 = jinit_params(jargs, seed=0)
    port = [flax_tree_from_state_dict(sd)
            for sd in load_msgpack_weights(res["weights"])]
    for loaded, init, mine in ((ep, ep0, port[0]), (dp, dp0, port[1])):
        got = dict(_leaves(loaded["params"]))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in _leaves(init["params"])}
        for k, v in _leaves(mine):
            assert np.array_equal(got[k], v), k
    scan = np.load(os.path.join(root, "scene0", "0", "0.npz"))["lidar_pcd"]
    pts = np.zeros((1, 2048, 3), np.float32)
    pts[0, :len(scan)] = scan[:2048]
    valid = np.zeros((1, 2048), bool)
    valid[0, :len(scan)] = True
    engine = JEngine(jargs, ep, dp, encoder=enc, decoder=dec,
                     preprocess_cfg=jinfer.device_preprocess_config(jargs))
    desc, dvalid, _ = engine.extract(pts, valid)
    assert np.isfinite(np.asarray(desc)).all() and np.asarray(dvalid).any()


def test_main_asked_for_cuda_without_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--root", str(tmp_path / "w"), "--out",
                   str(tmp_path / "o"), "--frames", "4"])


def _slam(pkg: str, seq: str, out: str):
    """The committed demo weights through run_sequence over `seq`, loops
    on. -> (exit codes, keyframe timesteps, graph timesteps, poses, ground
    truth, odometry and loop edges)."""
    codes = []
    if pkg == "jax":
        args = JDEMO.demo_args(os.path.dirname(os.path.dirname(seq)), out)
        enc, dec, ep, dp = jload_weights(args, WEIGHTS)
        engine = JEngine(args, ep, dp, encoder=enc, decoder=dec,
                         preprocess_cfg=jinfer.device_preprocess_config(args))
        mod = jinfer
    else:
        args = demo.demo_args(os.path.dirname(os.path.dirname(seq)), out)
        engine = InferenceEngine(args, *load_msgpack_weights(WEIGHTS),
                                 device="cpu",
                                 preprocess_cfg=tinfer.device_preprocess_config(
                                     args))
        mod = tinfer
    step = mod.SlamSystem.step

    def recorded(self, data):
        code = step(self, data)
        codes.append(code.name)
        return code

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.SlamSystem, "step", recorded)
        system = mod.run_sequence(args, engine, seq, out, system_id=1)
    pg = system.posegraph_map
    scans = sorted(pg.get_all_scans(), key=lambda s: s.timestep)
    return dict(codes=codes,
                keysteps=np.loadtxt(os.path.join(
                    out, "trajectory.keysteps.txt"), ndmin=1).tolist(),
                timesteps=[int(s.timestep) for s in scans],
                pred=np.stack([s.SE3_pred for s in scans]),
                gt=np.stack([s.SE3_gt for s in scans]),
                edges=(int(pg.odom_edge_num), int(pg.loop_edge_num)))


def test_committed_weights_same_decisions_in_both_packages(tmp_path):
    demo.write_world(str(tmp_path / "world"), FRAMES)
    seq = tmp_path / "first" / "scene0" / "0"
    seq.mkdir(parents=True)
    for i in range(SLAM_FRAMES):
        shutil.copy(tmp_path / "world" / "scene0" / "0" / f"{i}.npz",
                    seq / f"{i}.npz")
    port = _slam("port", str(seq), str(tmp_path / "out_port"))
    jax_run = _slam("jax", str(seq), str(tmp_path / "out_jax"))
    assert len(port["codes"]) == SLAM_FRAMES
    assert port["codes"] == jax_run["codes"]
    assert port["keysteps"] == jax_run["keysteps"]
    assert len(port["keysteps"]) >= 2
    assert port["timesteps"] == jax_run["timesteps"]
    assert port["edges"] == jax_run["edges"]
    assert abs(ate_rmse(port["pred"], port["gt"], align=True)
               - jate(jax_run["pred"], jax_run["gt"], align=True)) \
        <= ATE_TOL_M
    np.testing.assert_allclose(port["pred"][:, :3, 3],
                               jax_run["pred"][:, :3, 3], atol=POSE_TOL_M)
