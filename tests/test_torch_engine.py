"""The port's InferenceEngine end to end against the JAX package's on the
CPU: the same synthetic frames, random weights made by the JAX package,
the int16 upload and the information matrix at stride 4, with device
preprocessing ("device") and with normalized inputs ("host").

With device preprocessing the survivor sets may differ on a few points
(<= 0.5%), and one survivor that differs changes every later FPS pick; so
there the port's descriptors are held against the JAX encoder run on the
port's own survivors, and the strict pose tolerances are asserted on the
host engines, whose inputs are the same points. Two-point neighbourhoods
get the +z normal in both packages (tests/test_torch_ops.
_pin_two_point_normals): their normal is rounding noise in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.data import synthetic as jsyn
from deeppointmap_tpu.data.preprocess import PreprocessConfig as JPre
from deeppointmap_tpu.data.voxel import voxel_downsample_indices as jvox
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig as TPre
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from tests.test_torch_models import SMALL, jax_args
from tests.test_torch_ops import _pin_two_point_normals, relerr, rotation_deg

torch.set_num_threads(2)

N_PAD = 2048


def frames(n=4):
    """Raw-meter scans along a circle, voxel-downsampled at 0.3 m and
    padded: (points (n, N_PAD, 3), valid (n, N_PAD))."""
    rng = np.random.default_rng(5)
    world = jsyn.make_world(rng, n_clusters=60, extent=30.0,
                            pts_per_cluster=300)
    poses = jsyn.circle_trajectory(40, radius=12.0)
    pts = np.zeros((n, N_PAD, 3), np.float32)
    valid = np.zeros((n, N_PAD), bool)
    for i in range(n):
        xyz = jsyn.render_scan(world, poses[i], sensor_range=35.0,
                               max_points=8000, rng=rng)
        xyz = xyz[jvox(xyz, 0.3, "first")][:N_PAD - 100]
        pts[i, :len(xyz)] = xyz
        valid[i, :len(xyz)] = True
    return pts, valid


@pytest.fixture(scope="module")
def engines():
    """{"device": (JAX engine, port engine), "host": (...)}, the frames
    and the JAX encoder with its params."""
    with pytest.MonkeyPatch.context() as mp:
        _pin_two_point_normals(mp)
        enc, dec, enc_p, dec_p = init_params(jax_args(), seed=1)
        states = state_dicts_from_jax(enc_p, dec_p)
        out = {}
        for mode in ("device", "host"):
            on = mode == "device"
            j_eng = JEngine(jax_args(), enc_p, dec_p, encoder=enc,
                            decoder=dec, preprocess_cfg=JPre.from_transforms(
                                SMALL["transforms"]) if on else None)
            t_eng = InferenceEngine(
                config_from_dict(SMALL), *states,
                preprocess_cfg=TPre.from_transforms(SMALL["transforms"])
                if on else None, device="cpu")
            assert j_eng.infomat_stride == t_eng.infomat_stride == 4
            assert j_eng.upload_quant == t_eng.upload_quant == "int16"
            out[mode] = (j_eng, t_eng)
        yield out, frames(), (enc, enc_p)


def _normalized(pts):
    return (pts / np.float32(60.0)).astype(np.float32)


def _check_device_extract(t_out, j_out, pts, jax_encoder):
    """Survivors within 0.5% of the JAX engine's; descriptors relerr <=
    5e-4 against the JAX encoder on the port's survivors."""
    (td, tdv, tpv), (jd, jdv, jpv) = t_out, j_out
    assert td.shape == jd.shape
    assert np.sum(tpv != jpv) <= 0.005 * np.sum(jpv)
    enc, enc_p = jax_encoder
    q = np.clip(np.round(pts / 0.002), -32767, 32767).astype(np.int16)
    pts_n = (q.astype(np.float32) * np.float32(0.002)) / np.float32(60.0)
    c, f, v = (np.asarray(x) for x in enc.apply(
        enc_p, jnp.asarray(pts_n), jnp.asarray(tpv)))
    np.testing.assert_array_equal(tdv, v)
    assert relerr(td, np.concatenate([f, c * 60.0], -1)) <= 5e-4


def _check_host_extract(t_out, j_out):
    (td, tdv, tpv), (jd, jdv, jpv) = t_out, j_out
    np.testing.assert_array_equal(tpv, jpv)
    np.testing.assert_array_equal(tdv, jdv)
    assert relerr(td, jd) <= 5e-4


def test_extract_matches_jax(engines):
    eng, (pts, valid), jax_encoder = engines
    for i in range(len(pts)):
        j_eng, t_eng = eng["device"]
        _check_device_extract(t_eng.extract(pts[i:i + 1], valid[i:i + 1]),
                              j_eng.extract(pts[i:i + 1], valid[i:i + 1]),
                              pts[i:i + 1], jax_encoder)
    j_eng, t_eng = eng["host"]
    x = _normalized(pts[:1])
    _check_host_extract(t_eng.extract(x, valid[:1]),
                        j_eng.extract(x, valid[:1]))


def test_encode_points_matches_jax(engines):
    eng, (pts, valid), _ = engines
    for j_eng, t_eng in eng.values():
        np.testing.assert_array_equal(t_eng.encode_points(pts[1], valid[1]),
                                      j_eng.encode_points(pts[1], valid[1]))


def _check_pose(t_se3, j_se3):
    assert rotation_deg(t_se3[:3, :3], j_se3[:3, :3]) <= 0.01
    assert np.linalg.norm(t_se3[:3, 3] - j_se3[:3, 3]) <= 1e-3


def test_odometry_step_matches_jax(engines):
    """The fused step on the same candidate: R within 0.01 deg, t within
    1 mm, confidence and rmse within 1e-4, info relerr <= 1e-4 (host
    engines); survivors and descriptors as in extract (device engines)."""
    eng, (pts, valid), jax_encoder = engines
    j_eng, t_eng = eng["device"]
    jd, jdv, jpv = j_eng.extract(pts[:1], valid[:1])
    cand = (jd[0], jdv[0], pts[0], jpv[0])
    _check_device_extract(
        t_eng.odometry_step(pts[1:2], valid[1:2], *cand)[:3],
        j_eng.odometry_step(pts[1:2], valid[1:2], *cand)[:3], pts[1:2],
        jax_encoder)

    j_eng, t_eng = eng["host"]
    x = _normalized(pts)
    jd, jdv, jpv = j_eng.extract(x[:1], valid[:1])
    cand = (jd[0], jdv[0], pts[0], jpv[0])
    j = j_eng.odometry_step(x[1:2], valid[1:2], *cand)
    got = t_eng.odometry_step(x[1:2], valid[1:2], *cand)
    _check_host_extract(got[:3], j[:3])
    _check_pose(got[3], j[3])
    assert abs(got[4] - j[4]) <= 1e-4 and abs(got[5] - j[5]) <= 1e-4
    assert j[6][3, 3] > 0
    assert relerr(got[6], j[6]) <= 1e-4


def test_register_with_info_and_loop_scores_match_jax(engines):
    eng, (pts, valid), _ = engines
    j_eng, t_eng = eng["device"]
    jd, jdv, jpv = j_eng.extract(pts[2:4], valid[2:4])
    args = (jd[0], jdv[0], jd[1], jdv[1], pts[2], jpv[0], pts[3], jpv[1])
    j = j_eng.register_with_info(*args)
    got = t_eng.register_with_info(*args)
    _check_pose(got[0], j[0])
    assert abs(got[1] - j[1]) <= 1e-4 and abs(got[2] - j[2]) <= 1e-4
    assert relerr(got[3], j[3]) <= 1e-4
    # loop scoring: a batch of 3 padded to the bucket of 4
    src, dst = jd[[0, 1, 0]], jd[[1, 0, 0]]
    sv, dv = jdv[[0, 1, 0]], jdv[[1, 0, 0]]
    np.testing.assert_allclose(t_eng.loop_scores(src, dst, sv, dv),
                               j_eng.loop_scores(src, dst, sv, dv),
                               rtol=0, atol=1e-4)
    SE3 = j[0].copy()
    assert relerr(t_eng.compute_information_matrix(pts[2], jpv[0], pts[3],
                                                   jpv[1], SE3),
                  j_eng.compute_information_matrix(pts[2], jpv[0], pts[3],
                                                   jpv[1], SE3)) <= 1e-4


def test_extract_chunks_match_single(engines):
    """A batch of 5 runs as chunks of 4 (+1 padded) and gives what five
    single calls give."""
    eng, (pts, valid), _ = engines
    t_eng = eng["device"][1]
    b = np.concatenate([pts, pts[:1]]), np.concatenate([valid, valid[:1]])
    d_all, ov_all, pv_all = t_eng.extract(*b)
    assert d_all.shape[0] == 5
    for i in (0, 4):
        d1, ov1, pv1 = t_eng.extract(b[0][i:i + 1], b[1][i:i + 1])
        np.testing.assert_allclose(d_all[i], d1[0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ov_all[i], ov1[0])
        np.testing.assert_array_equal(pv_all[i], pv1[0])


def test_pad_tokens_buckets_and_crops(engines):
    t_eng = engines[0]["host"][1]
    rng = np.random.default_rng(2)
    desc = rng.normal(size=(300, 35)).astype(np.float32)
    out, ov, b = t_eng._pad_tokens(desc, np.ones(300, bool))
    assert b == 512 and out.shape == (512, 35) and ov.sum() == 300
    big = rng.normal(size=(1100, 35)).astype(np.float32)
    out, ov, b = t_eng._pad_tokens(big, np.ones(1100, bool))
    assert b == 1024 and out.shape[0] == 1024
    kept = np.linalg.norm(out[:, -3:], axis=1).max()
    assert kept <= np.sort(np.linalg.norm(big[:, -3:], axis=1))[1023] + 1e-6
