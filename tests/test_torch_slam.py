"""The slice as a whole on the CPU: synthetic frames through the port's
`SlamSystem` and the JAX package's, with `tests/test_slam_e2e.py
small_args`' model, random weights made by the JAX package and shared, the
sweep-reuse path on (`tpu.sweep_reuse`: the widened filter sweep serves the
encoder's stage-1 grouping; both packages take it at the exact grade, the
port through K2's plain version), `upload_quant: none, bf16: false`.

Decisions come first: every frame's exit code and the keyframe tokens must
be equal. Then each frame's pose relative to the frame before it: rotation
within 0.05 degrees, translation within 1 cm (float32 device results under
a different summation order, amplified by the Kabsch solve). The trajectory
files have the same shapes. The CLI (`pipeline.infer.main`) runs from a
temporary YAML file.
"""

import os

import numpy as np
import pytest
import torch

from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.config import TPU_DEFAULTS as J_TPU_DEFAULTS
from deeppointmap_tpu.data import synthetic as jsyn
from deeppointmap_tpu.data.dataset import BasicAgent as JAgent
from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu.slam.system import SlamSystem as JSlam
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import SlamSystem
from tests.test_slam_e2e import small_args
from tests.test_torch_ops import _pin_two_point_normals, rotation_deg

torch.set_num_threads(2)

N_FRAMES = 8


def _plain(x):
    """Config trees as plain dicts and lists (a copy)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def slam_config(tmp_path) -> dict:
    """small_args as a plain dict (its filter chain is the distance crop
    and the normalization, so both packages keep the same survivors: with
    the outlier and low-pass filters a few survivors differ, each changes
    every later FPS pick, and randomly initialized weights amplify that
    beyond any pose tolerance; tests/test_torch_sweep.py holds those
    filters against the JAX package on their own), with the sweep reuse,
    exact grades and no upload quantization."""
    cfg = _plain(small_args(tmp_path))
    cfg["transforms"]["VoxelSample"]["voxel_size"] = 0.3
    cfg["slam_system"] = dict(cfg["slam_system"], key_frame_distance=0.3,
                              loop_detection_trust_range=1,
                              loop_detection_rotation_min=0.0,
                              loop_detection_translation_min=0.0,
                              loop_detection_prob_acpt_threshold=0.0)
    cfg["tpu"] = dict(cfg["tpu"], encoder_points=2048, sweep_reuse=True,
                      upload_quant="none", neighbor_grade="exact",
                      filter_grade="exact", infomat_stride=1)
    cfg["infer_src"] = []
    return cfg


def write_sequence(root: str, n: int = N_FRAMES) -> None:
    """n synthetic scans along a circle (1.3 m apart) as KITTI .bin files."""
    rng = np.random.default_rng(11)
    world = jsyn.make_world(rng, n_clusters=60, extent=30.0,
                            pts_per_cluster=300)
    poses = jsyn.circle_trajectory(60, radius=12.0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        xyz = jsyn.render_scan(world, poses[i], sensor_range=35.0,
                               max_points=8000, rng=rng)
        np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)], 1).astype(
            np.float32).tofile(os.path.join(root, f"{i:06d}.bin"))


def jax_config(cfg: dict) -> JConfig:
    args = JConfig(cfg)
    tpu = JConfig(J_TPU_DEFAULTS)
    for k, v in cfg["tpu"].items():
        tpu[k] = v
    args.tpu = tpu
    return args


def run_both(tmp_path, mp):
    """-> (JAX SlamSystem, its exit codes, port SlamSystem, its exit
    codes), each after N_FRAMES steps over the same files."""
    _pin_two_point_normals(mp)
    seq = str(tmp_path / "seq")
    write_sequence(seq)
    cfg = slam_config(tmp_path)
    jargs, targs = jax_config(cfg), config_from_dict(cfg)
    enc, dec, enc_p, dec_p = init_params(jargs, seed=3)
    j_eng = JEngine(jargs, enc_p, dec_p, encoder=enc, decoder=dec,
                    preprocess_cfg=jinfer.device_preprocess_config(jargs))
    t_eng = InferenceEngine(targs, *state_dicts_from_jax(enc_p, dec_p),
                            preprocess_cfg=tinfer.device_preprocess_config(
                                targs), device="cpu")
    assert j_eng.preprocess_cfg.sweep_k == t_eng.preprocess_cfg.sweep_k == 17

    out = []
    for name, agent_cls, mod, system_cls, args, eng in (
            ("j", JAgent, jinfer, JSlam, jargs, j_eng),
            ("t", BasicAgent, tinfer, SlamSystem, targs, t_eng)):
        agent = agent_cls(root=seq, reader="auto")
        agent.set_independent(mod.make_infer_transform(args))
        os.makedirs(tmp_path / name, exist_ok=True)
        system = system_cls(args, eng, system_id=1,
                            logger_dir=str(tmp_path / name))
        codes = [system.step(agent[i]).name for i in range(N_FRAMES)]
        system.result_logger.save_trajectory("trajectory")
        system.result_logger.save_posegraph("trajectory")
        out += [system, codes]
    return tuple(out)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        tmp = tmp_path_factory.mktemp("torch_slam")
        yield (*run_both(tmp, mp), tmp)


def _scans(system):
    return sorted(system.posegraph_map.get_all_scans(),
                  key=lambda s: s.timestep)


def test_same_decisions(both):
    """Exit codes frame by frame, the keyframe tokens and the edge list
    (source, destination, type) are equal."""
    j_sys, j_codes, t_sys, t_codes, _ = both
    assert t_codes == j_codes
    assert len(set(j_codes)) > 1, "the frames should exercise two outcomes"
    kf = lambda s: [x.token for x in _scans(s) if x.type == "full"]
    assert kf(t_sys) == kf(j_sys) and len(kf(j_sys)) >= 3
    edges = lambda s: sorted((e.src_scan_token, e.dst_scan_token, e.type)
                             for e in s.posegraph_map.get_all_edges())
    assert edges(t_sys) == edges(j_sys)


def test_relative_poses_match(both):
    """Each accepted frame's pose relative to the frame before it:
    rotation <= 0.05 deg, translation <= 1 cm."""
    j_sys, _, t_sys, _, _ = both
    js, ts = _scans(j_sys), _scans(t_sys)
    assert [s.token for s in js] == [s.token for s in ts]
    for (ja, jb), (ta, tb) in zip(zip(js, js[1:]), zip(ts, ts[1:])):
        jr = np.linalg.inv(ja.SE3_pred) @ jb.SE3_pred
        tr = np.linalg.inv(ta.SE3_pred) @ tb.SE3_pred
        assert rotation_deg(tr[:3, :3], jr[:3, :3]) <= 0.05, tb.token
        assert np.linalg.norm(tr[:3, 3] - jr[:3, 3]) <= 0.01, tb.token


def test_trajectory_files_have_the_same_shapes(both):
    _, _, _, _, tmp = both
    for name in ("allframes", "allsteps", "keyframes", "keysteps"):
        j = np.loadtxt(tmp / "j" / f"trajectory.{name}.txt", ndmin=2)
        t = np.loadtxt(tmp / "t" / f"trajectory.{name}.txt", ndmin=2)
        assert t.shape == j.shape and t.shape[0] > 0, name
    g2o = lambda d: sorted(line.split()[0] for line in open(
        tmp / d / "trajectory.pg.g2o"))
    assert g2o("t") == g2o("j")


def test_port_engine_entry_points_were_reached(both):
    """The run went through the token cache: the port's engine holds the
    keyframes' descriptors and point clouds under their tokens."""
    _, _, t_sys, _, _ = both
    keys = set(t_sys.engine._dcache)
    for s in _scans(t_sys):
        if s.type == "full":
            assert (s.token, "kp_pad") in keys and (s.token, "pcd") in keys


def test_cli_main_from_yaml(tmp_path):
    """`pipeline.infer.main` from a temporary YAML file on the CPU with
    random weights: writes the settings snapshot and the result tree."""
    yaml = pytest.importorskip("yaml")
    seq = str(tmp_path / "seq")
    write_sequence(seq, n=3)
    cfg = slam_config(tmp_path)
    cfg.pop("weight")
    cfg.pop("multi_thread")
    cfg["infer_src"] = [seq, str(tmp_path / "missing")]
    cfg["infer_tgt"] = str(tmp_path / "out")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    tinfer.main(["--yaml_file", str(path), "--device", "cpu"])
    out = tmp_path / "out"
    assert (out / "settings.yaml").exists()
    rows = np.loadtxt(out / "Seq00" / "trajectory.allframes.txt", ndmin=2)
    assert rows.shape == (3, 12) and np.isfinite(rows).all()
    assert (out / "Seq00" / "trajectory.pg.g2o").exists()
    assert not (out / "Seq01").exists()


def test_unported_modes_are_refused_before_any_side_effect(tmp_path,
                                                           monkeypatch):
    """Nothing is refused any more: `tpu.encoder_bf16: true`, the last
    option the port refused, runs through both entry points' `main`. It
    reaches the encoder's gate, which gives float32 on the CPU, and every
    result is written."""
    yaml = pytest.importorskip("yaml")
    from deeppointmap_tpu_torch.models import encoder as tenc
    from deeppointmap_tpu_torch.pipeline import infer_multiagents as tma

    seen = set()
    gate = tenc.activation_dtype

    def spy(act_dtype, device):
        seen.add((act_dtype, device.type))
        return gate(act_dtype, device)

    monkeypatch.setattr(tenc, "activation_dtype", spy)
    rng = np.random.default_rng(11)
    world = jsyn.make_world(rng, n_clusters=60, extent=30.0,
                            pts_per_cluster=300)
    seq = jsyn.write_npz_sequence(
        str(tmp_path / "world"), world,
        jsyn.circle_trajectory(60, radius=12.0)[:6], rng=rng,
        sensor_range=35.0, max_points=8000)
    cfg = slam_config(tmp_path)
    cfg.pop("weight")
    cfg.pop("multi_thread")
    cfg["tpu"]["encoder_bf16"] = True
    cfg["infer_src"] = [seq]
    for name, main in (("infer", tinfer.main), ("ma", tma.main)):
        cfg["infer_tgt"] = str(tmp_path / name)
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        main(["--yaml_file", str(path), "--device", "cpu"])
    assert seen == {("bfloat16", "cpu")}
    for rows in (tmp_path / "infer" / "Seq00" / "trajectory.allframes.txt",
                 tmp_path / "ma" / "agent_1" / "trajectory.allframes.txt"):
        rows = np.loadtxt(rows, ndmin=2)
        assert rows.shape[1] == 12 and np.isfinite(rows).all()


def test_pth_weights_run_through_main(tmp_path):
    """A `.pth` weight file in the reference's schema (written by the JAX
    package from its random weights) loads to the state dicts those
    weights map to, and `pipeline.infer.main` runs with it."""
    yaml = pytest.importorskip("yaml")
    from deeppointmap_tpu.models.weights import save_torch_weight
    from deeppointmap_tpu_torch.pipeline.common import build_models

    cfg = slam_config(tmp_path)
    jargs, targs = jax_config(cfg), config_from_dict(cfg)
    _, _, enc_p, dec_p = init_params(jargs, seed=3)
    pth = str(tmp_path / "DeepPointMapAAAI.pth")
    save_torch_weight(pth, enc_p, dec_p, jargs)
    got = build_models(targs, pth)
    for g, w in zip(got, state_dicts_from_jax(enc_p, dec_p)):
        assert g.keys() == w.keys()
        assert all(torch.equal(g[k], w[k]) for k in w)

    seq = str(tmp_path / "seq")
    write_sequence(seq, n=3)
    cfg.pop("multi_thread")
    cfg.update(weight=pth, infer_src=[seq], infer_tgt=str(tmp_path / "out"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    tinfer.main(["--yaml_file", str(path), "--device", "cpu"])
    rows = np.loadtxt(tmp_path / "out" / "Seq00" / "trajectory.allframes.txt",
                      ndmin=2)
    assert rows.shape == (3, 12) and np.isfinite(rows).all()
