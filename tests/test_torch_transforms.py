"""The host transform chain (data/transforms.py), port against the JAX
package on the CPU: every transform of the registry on the same scan,
deterministic ones bit for bit and random ones under the same
np.random.Generator seed; the infer-mode preprocessing of
`tpu.device_preprocess: false`; and SLAM through that chain, held to
tests/test_torch_slam.py's rule (the same exit codes and keyframes, each
frame's relative pose within 0.05 degrees and 1 cm).
"""

import copy

import numpy as np
import pytest

from deeppointmap_tpu.data import synthetic as jsyn
from deeppointmap_tpu.data import transforms as jtf
from deeppointmap_tpu.data.readers import Scan as JScan
from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu.slam.system import SlamSystem as JSlam
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data import transforms as ttf
from deeppointmap_tpu_torch.data.readers import Scan
from deeppointmap_tpu_torch.data.readers import read_auto
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import SlamSystem
from tests.test_torch_ops import _pin_two_point_normals, rotation_deg
from tests.test_torch_slam import (N_FRAMES, _scans, jax_config,
                                   slam_config, write_sequence)

#: every registry entry with arguments that make it act on the test scan
CASES = {
    "GroundFilter": dict(img_len=60, img_width=60, grid_width=1.0,
                         ground_height=0.3),
    "OutlierFilter": dict(nb_neighbors=10, std_ratio=2.0),
    "LowPassFilter": dict(normals_radius=1.0, normals_num=16, filter_std=1.0,
                          flux=4),
    "VerticalCorrect": dict(angle=2.0),
    "VoxelSample": dict(voxel_size=0.5, retention="center"),
    "FarthestPointSample": dict(num=300),
    "RandomSample": dict(num=700),
    "DistanceSample": dict(min_dis=2.0, max_dis=20.0),
    "CoordinatesNormalization": dict(ratio=60.0),
    "RandomShuffle": dict(p=1.0),
    "RandomDrop": dict(max_ratio=0.4),
    "RandomShield": dict(angle_range=[20, 90], dis_range=[2, 10],
                         max_num=3, p=1.0),
    "RandomRT": dict(r_std=0.3, t_std=1.0, pair=True),
    "RandomPosJitter": dict(std=0.05),
    "ToGPU": {},
    "ToCPU": {},
    "ToTensor": dict(padding_to=4096),
}
#: more argument sets for the branches the first set leaves out
EXTRA = [("VoxelSample", dict(voxel_size=0.5, retention="first")),
         ("VoxelSample", dict(voxel_size=0.3, retention="first", num=400)),
         ("LowPassFilter", dict(normals_radius=1.0, normals_num=8,
                                filter_std=0.5, flux=2, max_remain=500)),
         ("RandomRT", dict(r_std=0.2, t_std=0.0, pair=False)),
         ("ToTensor", dict(padding_to=-1))]


def _xyz(seed: int = 4, n: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    world = jsyn.make_world(rng, n_clusters=40, extent=25.0,
                            pts_per_cluster=200)
    pose = jsyn.circle_trajectory(12, radius=8.0)[seed % 12]
    return jsyn.render_scan(world, pose, sensor_range=30.0, max_points=n,
                            rng=rng)


def _scan_pair(seed: int = 4):
    """The same scan as the port's and as the JAX package's Scan, with
    normals and a pose (so that every field a transform touches is
    compared)."""
    xyz = _xyz(seed)
    g = np.random.default_rng(seed + 1)
    norm = g.normal(size=xyz.shape).astype(np.float32)
    R = np.eye(3, dtype=np.float32)
    T = g.normal(size=(3, 1)).astype(np.float32)
    return (Scan(xyz.copy(), R.copy(), T.copy(), norm=norm.copy()),
            JScan(xyz.copy(), R.copy(), T.copy(), norm=norm.copy()))


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
        return
    if isinstance(want, JScan):
        for field in ("xyz", "rotation", "translation", "norm", "calib"):
            _same(getattr(got, field), getattr(want, field))
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


def test_registry_names_match():
    assert set(ttf.TRANSFORMS) == set(jtf.TRANSFORMS) == set(CASES)
    assert ttf._RANDOM == jtf._RANDOM


@pytest.mark.parametrize("name,kwargs", list(CASES.items()) + EXTRA,
                         ids=[n for n in CASES] + [n + "_more" for n, _ in
                                                   EXTRA])
def test_transform_matches_jax(name, kwargs):
    """Applied twice in a row (RandomRT pairs its calls), with the same
    Generator seed for the random ones: every output field equal."""
    t_scan, j_scan = _scan_pair()
    extra = {}
    if name in ttf._RANDOM:
        extra = dict(rng=np.random.default_rng(7)), dict(
            rng=np.random.default_rng(7))
    t = ttf.TRANSFORMS[name](**kwargs, **(extra[0] if extra else {}))
    j = jtf.TRANSFORMS[name](**kwargs, **(extra[1] if extra else {}))
    if name == "ToTensor":
        _same(t(t_scan), j(j_scan))
        return
    for _ in range(2):
        t_scan, j_scan = t(t_scan), j(j_scan)
        _same(t_scan, j_scan)
    assert t_scan.n_points > 0


def test_pipeline_with_random_choice_matches_jax():
    """get_transforms from a yaml-shaped dict with a RandomChoice and
    random stages, one Generator for the whole pipeline."""
    spec = {"DistanceSample": {"min_dis": 1.0, "max_dis": 25.0},
            "RandomChoice": {"transforms": {
                "RandomDrop": {"max_ratio": 0.2},
                "RandomPosJitter": {"std": 0.02},
                "VoxelSample": {"voxel_size": 0.4}}, "p": [1, 2, 1]},
            "RandomRT": {"r_std": 0.5},
            "CoordinatesNormalization": {"ratio": 60.0},
            "ToTensor": {"padding_to": 3000}}
    t = ttf.get_transforms(copy.deepcopy(spec), rng=np.random.default_rng(3))
    j = jtf.get_transforms(copy.deepcopy(spec), rng=np.random.default_rng(3))
    for seed in (4, 5, 6):
        t_scan, j_scan = _scan_pair(seed)
        _same(t(t_scan), j(j_scan))


def _host_config(tmp_path, chain: str) -> dict:
    """test_torch_slam's config with the host chain: `device_preprocess:
    false` on the standard chain, or the standard chain plus a stage that
    only the host has."""
    cfg = slam_config(tmp_path)
    if chain == "flag":
        cfg["tpu"]["device_preprocess"] = False
    else:
        cfg["transforms"] = dict(
            cfg["transforms"],
            GroundFilter=dict(img_len=100, img_width=100, grid_width=1.0,
                              ground_height=-1.0))
    return cfg


@pytest.mark.parametrize("chain", ["flag", "extra_stage"])
def test_make_infer_transform_host_branch_matches_jax(tmp_path, chain):
    """Both packages take the host branch (no device chain) and give the
    same normalized, padded arrays for every frame."""
    seq = str(tmp_path / "seq")
    write_sequence(seq, n=3)
    cfg = _host_config(tmp_path, chain)
    targs, jargs = config_from_dict(cfg), jax_config(cfg)
    assert tinfer.device_preprocess_config(targs) is None
    assert jinfer.device_preprocess_config(jargs) is None
    t_run = tinfer.make_infer_transform(targs)
    j_run = jinfer.make_infer_transform(jargs)
    from deeppointmap_tpu.data.readers import read_auto as jread
    for i in range(3):
        path = f"{seq}/{i:06d}.bin"
        got, want = t_run(read_auto(path)), j_run(jread(path))
        _same(got, want)
        pts, valid = got[0], got[3]
        assert pts.shape == (1, cfg["tpu"]["encoder_points"], 3)
        assert valid.sum() > 100 and np.abs(pts[valid]).max() <= 1.0


def _run_sequence(mp, infer_mod, system_cls, args, engine, seq, out):
    """`infer_mod.run_sequence`, recording every step's exit code."""
    codes, step = [], system_cls.step

    def recorded(self, data):
        code = step(self, data)
        codes.append(code.name)
        return code

    mp.setattr(system_cls, "step", recorded)
    system = infer_mod.run_sequence(args, engine, seq, out)
    mp.undo()
    return system, codes


@pytest.fixture(scope="module")
def host_chain_runs(tmp_path_factory):
    """Both packages' run_sequence on the same files with
    `tpu.device_preprocess: false`, random weights made by the JAX package
    and carried across. -> (JAX system, codes, port system, codes, tmp)."""
    tmp = tmp_path_factory.mktemp("torch_host_chain")
    seq = str(tmp / "seq")
    write_sequence(seq)
    cfg = slam_config(tmp)
    cfg["tpu"]["device_preprocess"] = False
    jargs, targs = jax_config(cfg), config_from_dict(cfg)
    enc, dec, enc_p, dec_p = init_params(jargs, seed=3)
    j_eng = JEngine(jargs, enc_p, dec_p, encoder=enc, decoder=dec,
                    preprocess_cfg=jinfer.device_preprocess_config(jargs))
    t_eng = InferenceEngine(targs, *state_dicts_from_jax(enc_p, dec_p),
                            preprocess_cfg=tinfer.device_preprocess_config(
                                targs), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _pin_two_point_normals(mp)
        j = _run_sequence(mp, jinfer, JSlam, jargs, j_eng, seq,
                          str(tmp / "j"))
        t = _run_sequence(mp, tinfer, SlamSystem, targs, t_eng, seq,
                          str(tmp / "t"))
    return (*j, *t, tmp)


def test_slam_through_the_host_chain_matches_jax(host_chain_runs):
    """`run_sequence` with `tpu.device_preprocess: false` on
    test_torch_slam.py's synthetic frames: the engines run without a device
    chain on normalized inputs; the same exit codes and keyframes; relative
    poses within 0.05 deg and 1 cm; trajectory files of the same shapes."""
    j_sys, j_codes, t_sys, t_codes, tmp = host_chain_runs
    assert t_sys.engine.preprocess_cfg is None
    assert j_sys.engine.preprocess_cfg is None
    assert t_codes == j_codes and len(t_codes) == N_FRAMES
    kf = lambda s: [x.token for x in _scans(s) if x.type == "full"]
    assert kf(t_sys) == kf(j_sys)
    js, ts = _scans(j_sys), _scans(t_sys)
    assert [s.token for s in js] == [s.token for s in ts]
    for (ja, jb), (ta, tb) in zip(zip(js, js[1:]), zip(ts, ts[1:])):
        jr = np.linalg.inv(ja.SE3_pred) @ jb.SE3_pred
        tr = np.linalg.inv(ta.SE3_pred) @ tb.SE3_pred
        assert rotation_deg(tr[:3, :3], jr[:3, :3]) <= 0.05, tb.token
        assert np.linalg.norm(tr[:3, 3] - jr[:3, 3]) <= 0.01, tb.token
    # scans are stored in meters: the engine's normalized input scaled back
    np.testing.assert_allclose(ts[0].full_pcd, js[0].full_pcd, atol=1e-5)
    for name in ("allframes", "keyframes"):
        j = np.loadtxt(tmp / "j" / f"trajectory.{name}.txt", ndmin=2)
        t = np.loadtxt(tmp / "t" / f"trajectory.{name}.txt", ndmin=2)
        assert t.shape == j.shape and t.shape[0] > 0, name
