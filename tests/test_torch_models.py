"""The port's encoder and decoder against the JAX package's on the CPU:
the same random weights (made by the JAX package, carried across by
state_dicts_from_jax) and the same inputs (made with numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.config import TPU_DEFAULTS as J_TPU_DEFAULTS
from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.models import common as jcommon
from deeppointmap_tpu.models.decoder import Decoder as JDecoder
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models import common as tcommon
from deeppointmap_tpu_torch.models.decoder import Decoder, num_pairs_for
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from tests.test_torch_ops import relerr, rotation_deg, scan

torch.set_num_threads(2)

#: a small model: 3 encoder stages (one with two InvResMLP blocks), narrow
#: widths, 1 attention layer
SMALL = dict(
    transforms={
        "DistanceSample": {"min_dis": 1.0, "max_dis": 60.0},
        "OutlierFilter": {"nb_neighbors": 10, "std_ratio": 3.0},
        "LowPassFilter": {"normals_radius": 0.5, "normals_num": 16,
                          "filter_std": 2.0, "flux": 4, "max_remain": -1},
        "CoordinatesNormalization": {"ratio": 60.0},
    },
    encoder=dict(npoint=[256, 64, 16],
                 radius_list=[[0.05, 0.1], [0.1, 0.2, 0.2], [0.2, 0.4]],
                 nsample_list=[[8, 8], [8, 8, 8], [8, 8]],
                 in_channel=3, out_channel=32, width=8, expansion=4,
                 upsample_layers=2, sample=[{"type": "fps"}] * 3, norm="LN",
                 bias=True),
    decoder=dict(in_channel=32, model_channel=64, attention_layers=1),
    loss=dict(tau=0.1, eps_offset=2.0),
    slam_system=dict(coor_scale=60),
    tpu=dict(encoder_points=2048, reg_buckets=[256, 512, 1024],
             loop_batch_buckets=[1, 4]),
)


def jax_args(cfg=SMALL):
    args = JConfig(cfg)
    tpu = JConfig(J_TPU_DEFAULTS)
    for k, v in cfg["tpu"].items():
        tpu[k] = v
    args.tpu = tpu
    return args


@pytest.fixture(scope="module")
def models():
    """(JAX encoder, decoder, their params, port encoder, port decoder)."""
    enc, dec, enc_p, dec_p = init_params(jax_args(), seed=0)
    args = config_from_dict(SMALL)
    enc_sd, dec_sd = state_dicts_from_jax(enc_p, dec_p)
    t_enc, t_dec = Encoder.from_config(args), Decoder.from_config(args)
    t_enc.load_state_dict(enc_sd)
    t_dec.load_state_dict(dec_sd)
    return enc, dec, enc_p, dec_p, t_enc.eval(), t_dec.eval()


def _inputs(seeds=(20, 21)):
    pts, valid = zip(*(scan(s) for s in seeds))
    return (np.stack(pts) / np.float32(60.0)).astype(np.float32), \
        np.stack(valid)


def test_state_dicts_load_strictly(models):
    """Every port parameter gets a Flax leaf and vice versa (load_state_dict
    is strict), with the Flax leaf count."""
    _, _, enc_p, dec_p, t_enc, t_dec = models
    n_flax = len(list(_leaves(enc_p))) + len(list(_leaves(dec_p)))
    assert n_flax == len(t_enc.state_dict()) + len(t_dec.state_dict())


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_encoder_matches_jax(models):
    """Coordinates and validity identical (FPS and kNN agree exactly);
    descriptors relerr <= 5e-4 (PARITY.md:108-110 bar; the two differ by
    f32 matmul rounding only)."""
    enc, _, enc_p, _, t_enc, _ = models
    pts, valid = _inputs()
    jc, jf, jv = (np.asarray(x) for x in enc.apply(enc_p, jnp.asarray(pts),
                                                   jnp.asarray(valid)))
    with torch.no_grad():
        tc, tf, tv = (x.numpy() for x in t_enc(torch.from_numpy(pts),
                                               torch.from_numpy(valid)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    assert tf.shape == jf.shape == (2, 256, 32)
    assert relerr(tf, jf) <= 5e-4


def _descriptors(models, seeds):
    enc, _, enc_p, _, _, _ = models
    pts, valid = _inputs(seeds)
    c, f, v = (np.asarray(x) for x in enc.apply(enc_p, jnp.asarray(pts),
                                                jnp.asarray(valid)))
    return np.concatenate([f, c * 60.0], -1).astype(np.float32), np.array(v)


@pytest.mark.parametrize("pad", [0, 256])
def test_registration_matches_jax(models, pad):
    """R within 0.01 deg, t within 1 mm, confidence and rmse within 1e-4,
    the same inlier count; `pad` appends invalid tokens (a bucket) and
    masks the extra pairs with num_pairs_actual."""
    _, dec, _, dec_p, _, t_dec = models
    desc, v = _descriptors(models, (22, 23))
    src, dst, sv, dv = desc[0], desc[1], v[0], v[1]
    m_real, n_real = int(sv.sum()), int(dv.sum())
    if pad:
        src = np.concatenate([src, np.zeros((pad, src.shape[1]),
                                            np.float32)])
        sv = np.concatenate([sv, np.zeros(pad, bool)])
    k_static = num_pairs_for(len(src), len(dst))
    k_actual = num_pairs_for(m_real, n_real)
    j = [np.asarray(x) for x in dec.apply(
        dec_p, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(sv),
        jnp.asarray(dv), k_static, jnp.int32(k_actual),
        method=JDecoder.registration)]
    with torch.no_grad():
        got = [x.numpy() for x in t_dec.registration(
            torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(sv), torch.from_numpy(dv), k_static, k_actual)]
    assert rotation_deg(got[0], j[0]) <= 0.01
    assert np.linalg.norm(got[1] - j[1]) <= 1e-3
    assert abs(float(got[2]) - float(j[2])) <= 1e-4
    assert abs(float(got[3]) - float(j[3])) <= 1e-4
    assert int(got[4]) == int(j[4])


def test_loop_detection_matches_jax(models):
    """Loop probabilities within 1e-4 absolute."""
    _, dec, _, dec_p, _, t_dec = models
    desc, v = _descriptors(models, (24, 25, 26))
    src, dst = desc, desc[[1, 2, 0]]
    sv, dv = v, v[[1, 2, 0]]
    j = np.asarray(dec.apply(dec_p, *(jnp.asarray(x) for x in
                                      (src, dst, sv, dv)),
                             method=JDecoder.loop_detection))
    with torch.no_grad():
        got = t_dec.loop_detection(*(torch.from_numpy(x) for x in
                                     (src, dst, sv, dv))).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, j, rtol=0, atol=1e-4)


def test_attention_and_embedding_match_jax():
    """MultiHeadAttention with a key mask, and the sine embedding, on the
    same weights: relerr <= 1e-5 (f32 matmul rounding)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 7, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 9, 16)).astype(np.float32)
    kvalid = rng.random((2, 9)) < 0.7
    kvalid[:, 0] = True
    jm = jcommon.MultiHeadAttention(16, num_heads=4)
    params = jm.init(jax.random.PRNGKey(1), q, kv, kv, kvalid)
    j = np.asarray(jm.apply(params, q, kv, kv, kvalid))
    tm = tcommon.MultiHeadAttention(16, num_heads=4)
    tm.load_state_dict(state_dicts_from_jax(params, {})[0])
    with torch.no_grad():
        got = tm(*(torch.from_numpy(x) for x in (q, kv, kv, kvalid))).numpy()
    assert relerr(got, j) <= 1e-5
    xyz = rng.normal(size=(2, 5, 3)).astype(np.float32)
    for dim in (64, 128, 70):
        jemb = np.asarray(jcommon.sine_pos_embedding(jnp.asarray(xyz), dim))
        temb = tcommon.sine_pos_embedding(torch.from_numpy(xyz), dim).numpy()
        assert relerr(temb, jemb) <= 1e-5


def test_config_from_yaml_matches_jax():
    """The port's loader reads configs/infer/sample.yaml into the same
    model trees and the same values of the `tpu:` keys it reads."""
    from deeppointmap_tpu.config import config_from_yaml as j_from_yaml
    from deeppointmap_tpu_torch.config import TPU_DEFAULTS
    from deeppointmap_tpu_torch.config import config_from_yaml

    path = "configs/infer/sample.yaml"
    j, got = j_from_yaml(path), config_from_yaml(path)
    for tree in ("transforms", "encoder", "decoder", "loss", "slam_system"):
        assert dict(got[tree]) == dict(j[tree]), tree
    for key in TPU_DEFAULTS:
        assert got.tpu[key] == j.tpu[key], key
    assert Encoder.from_config(got).npoint == (4096, 1024, 256, 64, 16)
