"""The RANSAC solve (`tpu.robust_register`), port against the JAX package
on the CPU.

The hypotheses come from `jax.random.gumbel(PRNGKey(0), (1024, K))`, which
the port reproduces without JAX: the uniform bits exactly, each float32 log
within one ulp of JAX's (JAX's own float32 log is not correctly rounded).
On the seeded correspondence sets below the picked samples and the inlier
masks are then equal; a pick could still part where two logits of a row
lie within that ulp, which these sets do not hit. R within 1e-5, t within
1e-4 m and rmse relerr <= 1e-4 (float32 solves in another summation
order). The decoder with `robust_register` is held to
test_torch_models.py's registration tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.models.decoder import Decoder as JDecoder
from deeppointmap_tpu.ops import kabsch as jkabsch
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models.decoder import Decoder, num_pairs_for
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.ops import kabsch as tkabsch
from tests.test_torch_models import SMALL, _descriptors, jax_args, models
from tests.test_torch_ops import rotation_deg

torch.set_num_threads(2)

N_HYP = 1024
#: the pair counts K = 2 * num_pairs_for(m, n) of registration at
#: sample.yaml's reg_buckets: odometry and scan-to-map (a bucket against
#: a scan's 256 tokens) and map-to-map (the largest tiles)
BUCKET_KS = sorted({2 * num_pairs_for(m, 256) for m in
                    (256, 512, 1024, 2048, 4096)}
                   | {2 * num_pairs_for(4096, 4096)})

assert models  # the module fixture, imported for the decoder test


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def test_bucket_ks():
    assert BUCKET_KS == [256, 384, 640, 1152, 2176, 4096]


@pytest.mark.parametrize("k", BUCKET_KS)
def test_gumbel_noise_matches_jax(k):
    """The uniform bit for bit; each of the two logs within one ulp of
    JAX's on the same input; the noise within twice what one ulp of each
    log becomes (both packages round after each log)."""
    tiny = np.finfo(np.float32).tiny
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, (N_HYP * k,), minval=tiny,
                                      maxval=1.0))
    got_u = tkabsch.uniform_bits(N_HYP * k, "cpu").numpy()
    np.testing.assert_array_equal(got_u.view(np.int32), u.view(np.int32))
    inner = np.asarray(jnp.log(u))
    assert np.all(np.abs(tkabsch.log32(torch.from_numpy(u.copy())).numpy()
                         - inner) <= _ulp(inner))
    j = np.asarray(jax.random.gumbel(key, (N_HYP, k))).ravel()
    outer = -tkabsch.log32(-torch.from_numpy(inner.copy())).numpy()
    assert np.all(np.abs(outer - j) <= _ulp(j))
    got = tkabsch.gumbel_noise(N_HYP, k, "cpu").numpy().ravel()
    bound = _ulp(j) + _ulp(inner) / np.abs(inner.astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - j) <= 2 * bound)


def _correspondences(seed: int, k: int = 256):
    """K pairs dst = R src + t + 2 cm noise, of which a share in [0.5, 0.8]
    are confident outliers (random targets, the same confidences as the
    inliers) and a few are invalid."""
    g = np.random.default_rng(seed)
    src = g.uniform(-20, 20, (k, 3))
    a = g.normal(size=3)
    a *= g.uniform(0.05, 0.6) / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = np.linalg.norm(a)
    R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K
    t = g.uniform(-3, 3, 3)
    dst = src @ R.T + t + g.normal(0, 0.02, (k, 3))
    out = g.random(k) < g.uniform(0.5, 0.8)
    dst[out] = g.uniform(-20, 20, (int(out.sum()), 3))
    w = g.uniform(0.05, 1.0, k)
    valid = g.random(k) >= 0.05
    return [x.astype(np.float32) for x in (src, dst, w)] + [valid]


def _jax_hypotheses(w, valid):
    w_masked = jnp.where(valid, w, 0.0)
    logits = (jnp.log(jnp.maximum(w_masked, 1e-9))[None, :]
              + jax.random.gumbel(jax.random.PRNGKey(0), (N_HYP, len(w))))
    return np.asarray(jax.lax.top_k(logits, 3)[1])


@pytest.mark.parametrize("seed", range(24))
def test_ransac_kabsch_matches_jax(seed):
    src, dst, w, valid = _correspondences(seed)
    j = [np.asarray(x) for x in jkabsch.ransac_kabsch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        jnp.asarray(valid))]
    t_in = [torch.from_numpy(x) for x in (src, dst, w, valid)]
    got = [x.numpy() for x in tkabsch.ransac_kabsch(*t_in)]
    w_masked = torch.where(t_in[3], t_in[2], torch.zeros_like(t_in[2]))
    np.testing.assert_array_equal(
        tkabsch.hypotheses(w_masked, N_HYP).numpy(),
        _jax_hypotheses(w, valid))
    np.testing.assert_array_equal(got[2], j[2])
    assert j[2].sum() >= 20
    assert np.abs(got[0] - j[0]).max() <= 1e-5
    assert np.abs(got[1] - j[1]).max() <= 1e-4
    assert abs(float(got[3]) - float(j[3])) <= 1e-4 * abs(float(j[3]))


def test_batched_solve_matches_unbatched():
    """`_solve_rt` over a leading batch index equals one solve per entry."""
    g = np.random.default_rng(3)
    src = torch.from_numpy(g.normal(size=(5, 9, 3)).astype(np.float32))
    dst = torch.from_numpy(g.normal(size=(5, 9, 3)).astype(np.float32))
    w = torch.from_numpy(g.uniform(0, 1, (5, 9)).astype(np.float32))
    R, t = tkabsch._solve_rt(src, dst, w)
    for i in range(5):
        Ri, ti = tkabsch._solve_rt(src[i], dst[i], w[i])
        assert torch.allclose(R[i], Ri, atol=1e-6)
        assert torch.allclose(t[i], ti, atol=1e-6)


def _moved_copy(desc, v, seed: int):
    """The descriptors of one scan, and the same descriptors with their
    xyz moved by 4 degrees about z and (1, -0.5, 0.2) m, in another order:
    the decoder pairs equal features, so the solve has a real consensus.
    (Two unrelated scans under random weights leave a 3-pair consensus,
    whose rmse the coverage clip multiplies by 64 in both packages, and
    the float32 rounding of that tiny solve with it.)"""
    g = np.random.default_rng(seed)
    a = np.radians(4.0)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    dst = desc.copy()
    dst[:, -3:] = desc[:, -3:] @ R.T + np.array([1.0, -0.5, 0.2])
    perm = g.permutation(len(desc))
    return desc, v, dst[perm].astype(np.float32), v[perm]


@pytest.mark.parametrize("pad", [0, 256])
def test_robust_registration_matches_jax(models, pad):
    """Decoder.registration with robust_register in both packages: R
    within 0.01 deg, t within 1 mm, confidence and rmse within 1e-4, the
    same inlier count (test_torch_models.py's rule), on a scan against a
    moved copy of itself."""
    cfg = dict(SMALL, tpu=dict(SMALL["tpu"], robust_register=True))
    _, jdec, enc_p, dec_p = init_params(jax_args(cfg), seed=0)
    assert jdec.robust_register
    t_dec = Decoder.from_config(config_from_dict(cfg))
    assert t_dec.robust_register
    t_dec.load_state_dict(state_dicts_from_jax(enc_p, dec_p)[1])
    t_dec.eval()
    desc, v = _descriptors(models, (22,))
    src, sv, dst, dv = _moved_copy(desc[0], v[0], pad)
    m_real, n_real = int(sv.sum()), int(dv.sum())
    if pad:
        src = np.concatenate([src, np.zeros((pad, src.shape[1]),
                                            np.float32)])
        sv = np.concatenate([sv, np.zeros(pad, bool)])
    k_static = num_pairs_for(len(src), len(dst))
    k_actual = num_pairs_for(m_real, n_real)
    j = [np.asarray(x) for x in jdec.apply(
        dec_p, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(sv),
        jnp.asarray(dv), k_static, jnp.int32(k_actual),
        method=JDecoder.registration)]
    with torch.no_grad():
        got = [x.numpy() for x in t_dec.registration(
            torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(sv), torch.from_numpy(dv), k_static, k_actual)]
    assert int(j[4]) >= 10
    assert rotation_deg(got[0], j[0]) <= 0.01
    assert np.linalg.norm(got[1] - j[1]) <= 1e-3
    assert abs(float(got[2]) - float(j[2])) <= 1e-4
    assert abs(float(got[3]) - float(j[3])) <= 1e-4
    assert int(got[4]) == int(j[4])
