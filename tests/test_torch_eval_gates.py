"""The compact recipe's model under the evaluation gates, in both packages
on the CPU: the JAX package's artifacts/full_size weights on the compact
two-lap world, single-agent, loops on, under full_eval_args (the RANSAC
solve with its coverage-scaled rmse gated at 1.0 m, confidence at 0.3).

This is the check behind the finding that the compact models' large
two-lap ATEs under these gates are the reference's behaviour, not the
port's: `build_eval_world` of deeppointmap_tpu_torch/pipeline/full_size.py
and of scripts/train_full_size.py write bit-equal worlds, the two
`full_eval_args` are equal, and the two SLAM systems then take the same
exit code frame by frame, keep the same keyframes and edges, and reach the
same aligned ATE (within ATE_TOL_M) and poses (within POSE_TOL_M).

Frames: FRAMES, the fewest that include frames the rmse gate drops and the
system's answer to them: the first frame this model registers to frame 0
at an rmse above the gate (with a confidence above its gate) is frame 1,
frames 1-4 are dropped, and the fifth drop in a row (frame 5) is taken back
by `continuous_drop_scan_strategy: recover`, which leaves two poses to
align. The test asserts that the rmse gate dropped a frame.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import load_weights as jload_weights
from deeppointmap_tpu.slam import modules as jmodules
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu.utils.evaluation import ate_rmse as jate
from deeppointmap_tpu_torch.pipeline import full_size as fs
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.pipeline.common import load_weights
from deeppointmap_tpu_torch.slam import modules as tmodules
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "artifacts/full_size/weights_final.msgpack")
FRAMES = 6
ATE_TOL_M = 1e-3
POSE_TOL_M = 1e-3
SETTINGS = ("WORLD", "RENDER", "EVAL_WORLD")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _run(pkg_infer, pkg_modules, args, engine, seq, out):
    """run_sequence with every step's exit code and every drop-gate
    decision (code, rmse, confidence) recorded."""
    codes, gates = [], []
    step, check = pkg_infer.SlamSystem.step, \
        pkg_modules.MappingModule.valid_check

    def recorded_step(self, data):
        code = step(self, data)
        codes.append(code.name)
        return code

    def recorded_check(self, new_scan, edge):
        out_ = check(self, new_scan, edge)
        gates.append((out_[0].name, float(edge.rmse),
                      float(edge.confidence)))
        return out_

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pkg_infer.SlamSystem, "step", recorded_step)
        mp.setattr(pkg_modules.MappingModule, "valid_check", recorded_check)
        system = pkg_infer.run_sequence(args, engine, seq, out, system_id=1)
    pg = system.posegraph_map
    scans = sorted(pg.get_all_scans(), key=lambda s: s.timestep)
    pred = np.stack([s.SE3_pred for s in scans])
    gt = np.stack([s.SE3_gt for s in scans])
    return dict(codes=codes, gates=gates, pred=pred, gt=gt,
                timesteps=[int(s.timestep) for s in scans],
                keysteps=np.loadtxt(os.path.join(
                    out, "trajectory.keysteps.txt"), ndmin=1).tolist(),
                odom_edges=int(pg.odom_edge_num),
                loop_edges=int(pg.loop_edge_num))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_gates")
    jfs = _load("jax_train_full_size_gates",
                os.path.join(REPO, "scripts/train_full_size.py"))
    saved = {k: dict(getattr(fs, k)) for k in SETTINGS}
    try:
        roots = {}
        for name, mod in (("port", fs), ("jax", jfs)):
            mod.apply_artifact_render(WEIGHTS)
            roots[name] = str(tmp / f"world_{name}")
            mod.build_eval_world(roots[name])
        # both read the port's world (the two are compared bit for bit)
        args = {"port": fs.full_eval_args(roots["port"], str(tmp / "o")),
                "jax": jfs.full_eval_args(roots["port"], str(tmp / "o"))}
    finally:
        for k, v in saved.items():
            getattr(fs, k).clear()
            getattr(fs, k).update(v)
    # the first FRAMES scans of the port's world, as their own sequence
    agent = os.path.join(roots["port"], "scene0", "0")
    seq = tmp / "first" / "scene0" / "0"
    seq.mkdir(parents=True)
    for i in range(FRAMES):
        shutil.copy(os.path.join(agent, f"{i}.npz"), seq / f"{i}.npz")

    targs = args["port"]
    engine = InferenceEngine(targs, *load_weights(targs, WEIGHTS),
                             device="cpu",
                             preprocess_cfg=tinfer.device_preprocess_config(
                                 targs))
    port = _run(tinfer, tmodules, targs, engine, str(seq),
                str(tmp / "out_port"))
    jargs = args["jax"]
    enc, dec, ep, dp = jload_weights(jargs, WEIGHTS)
    jengine = JEngine(jargs, ep, dp, encoder=enc, decoder=dec,
                      preprocess_cfg=jinfer.device_preprocess_config(jargs))
    jax_run = _run(jinfer, jmodules, jargs, jengine, str(seq),
                   str(tmp / "out_jax"))
    return dict(roots=roots, args=args, port=port, jax=jax_run)


def test_worlds_are_bit_equal(runs):
    a, b = (os.path.join(runs["roots"][k], "scene0") for k in ("port",
                                                                "jax"))
    names = sorted(os.listdir(os.path.join(a, "0")))
    assert names == sorted(os.listdir(os.path.join(b, "0")))
    assert len(names) == 2 * fs.DEFAULT_EVAL["frames_per_lap"]
    for name in names:
        za, zb = (np.load(os.path.join(d, "0", name)) for d in (a, b))
        assert za.files == zb.files
        for key in za.files:
            assert za[key].dtype == zb[key].dtype
            assert np.array_equal(za[key], zb[key]), (name, key)
    with open(os.path.join(a, "world_meta.json")) as f, \
            open(os.path.join(b, "world_meta.json")) as g:
        assert f.read() == g.read()


def test_eval_args_are_equal(runs):
    port, jax_args = runs["args"]["port"], runs["args"]["jax"]
    for tree in ("dataset", "transforms", "encoder", "decoder", "loss",
                 "slam_system"):
        assert _plain(port[tree]) == _plain(jax_args[tree]), tree
    assert port.tpu.robust_register and jax_args.tpu.robust_register


def test_same_exit_codes_frame_by_frame(runs):
    assert len(runs["port"]["codes"]) == FRAMES
    assert runs["port"]["codes"] == runs["jax"]["codes"]
    assert [g[0] for g in runs["port"]["gates"]] == \
        [g[0] for g in runs["jax"]["gates"]]


def test_the_rmse_gate_dropped_a_frame(runs):
    """In both packages: a drop whose rmse is above the gate while its
    confidence passes (the rmse gate alone made it)."""
    ss = runs["args"]["port"].slam_system
    for pkg in ("port", "jax"):
        rmse_drops = [g for g in runs[pkg]["gates"] if g[0] == "drop"
                      and g[1] > ss.edge_rmse_drop
                      and g[2] >= ss.edge_confidence_drop]
        assert rmse_drops, (pkg, runs[pkg]["gates"])
    # the gates saw the same registrations
    got = np.array([g[1:] for g in runs["port"]["gates"]])
    want = np.array([g[1:] for g in runs["jax"]["gates"]])
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_same_keyframes_and_edges(runs):
    port, jax_run = runs["port"], runs["jax"]
    assert port["timesteps"] == jax_run["timesteps"]
    assert port["keysteps"] == jax_run["keysteps"]
    assert port["odom_edges"] == jax_run["odom_edges"]
    assert port["loop_edges"] == jax_run["loop_edges"]


def test_same_ate_and_poses(runs):
    port, jax_run = runs["port"], runs["jax"]
    np.testing.assert_allclose(port["gt"], jax_run["gt"], atol=1e-6)
    assert abs(ate_rmse(port["pred"], port["gt"], align=True)
               - jate(jax_run["pred"], jax_run["gt"], align=True)) \
        <= ATE_TOL_M
    np.testing.assert_allclose(port["pred"][:, :3, 3],
                               jax_run["pred"][:, :3, 3], atol=POSE_TOL_M)
