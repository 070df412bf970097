"""The port's training loss (models/loss.py) and Decoder.train_forward
against the JAX package's on the same inputs, made from a numpy seed.

Tolerances: loss terms relerr <= 1e-5 (float32 sums in another order);
gradients with respect to the features and offsets ||d|| / ||g|| <= 1e-4
against jax.grad; the proximity pairs of train_forward identical, also
when more pairs are near than `max_pairs` (the selection among ties that
jax.lax.top_k makes), and its outputs relerr <= 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.models import loss as jloss
from deeppointmap_tpu.models.decoder import Decoder as JDecoder
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models import loss as tloss
from deeppointmap_tpu_torch.models.decoder import Decoder, first_pairs
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from tests.test_trainer import train_args

FIELDS = ("loss", "loss_pairing", "loss_coarse", "loss_offset", "top1_acc")
FEATURES = ("src_pairing_fea", "dst_pairing_fea", "src_coarse_fea",
            "dst_coarse_fea", "src_offset_res", "dst_offset_res")


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def loss_inputs(seed: int, B=2, S=40, D=36, C=16, P=25):
    """Clustered coordinates (so that some pairs fall within eps), some
    invalid tokens, features and offset residuals."""
    rng = np.random.default_rng(seed)
    src_g = rng.uniform(-4, 4, size=(B, S, 3)).astype(np.float32)
    dst_g = (src_g[:, :D] + rng.normal(0, 0.8, size=(B, D, 3))).astype(
        np.float32)
    src_v = rng.random((B, S)) > 0.1
    dst_v = rng.random((B, D)) > 0.1
    dec = {"src_pairing_fea": rng.normal(size=(B, S, C)),
           "dst_pairing_fea": rng.normal(size=(B, D, C)),
           "src_coarse_fea": rng.normal(size=(B, S, C)),
           "dst_coarse_fea": rng.normal(size=(B, D, C)),
           "src_offset_res": rng.normal(size=(B, P, 3)),
           "dst_offset_res": rng.normal(size=(B, P, 3))}
    dec = {k: v.astype(np.float32) for k, v in dec.items()}
    dec["pair_valid"] = rng.random((B, P)) > 0.3
    return src_g, dst_g, src_v, dst_v, dec


def both(cfg_kwargs, src_g, dst_g, src_v, dst_v, dec):
    jcfg = jloss.LossConfig(**cfg_kwargs)
    tcfg = tloss.LossConfig(**cfg_kwargs)
    want = jloss.registration_loss(jcfg, jnp.asarray(src_g),
                                   jnp.asarray(dst_g), jnp.asarray(src_v),
                                   jnp.asarray(dst_v),
                                   {k: jnp.asarray(v) for k, v in dec.items()})
    got = tloss.registration_loss(tcfg, torch.from_numpy(src_g),
                                  torch.from_numpy(dst_g),
                                  torch.from_numpy(src_v),
                                  torch.from_numpy(dst_v),
                                  {k: torch.from_numpy(v)
                                   for k, v in dec.items()})
    return got, want


@pytest.mark.parametrize("mode", ["euclidean", "manhattan", "mahalanobis"])
@pytest.mark.parametrize("seed", [0, 1])
def test_registration_loss_matches_jax(mode, seed):
    got, want = both(dict(offset_value=mode, lambda_c=0.5, lambda_o=0.3),
                     *loss_inputs(seed))
    for k in FIELDS:
        assert np.isfinite(float(got[k]))
        assert relerr(got[k].item(), float(want[k])) <= 1e-5, k


@pytest.mark.parametrize("case", ["planar", "single_pair", "small_scale"])
def test_mahalanobis_fallback_matches_jax(case):
    """Residuals on a plane (rank-2 covariance) and a single valid pair
    (zero covariance) take the identity metric, so the offset term equals
    the euclidean one; well-conditioned residuals at 1e-3 m keep the
    whitening (the gate is scale-relative)."""
    src_g, dst_g, src_v, dst_v, dec = loss_inputs(3)
    rng = np.random.default_rng(4)
    if case == "planar":
        for k in ("src_offset_res", "dst_offset_res"):
            dec[k][..., 2] = 0.0
    elif case == "single_pair":
        dec["pair_valid"][:] = False
        dec["pair_valid"][0, 3] = True
    else:
        for k in ("src_offset_res", "dst_offset_res"):
            dec[k] = (1e-3 * rng.normal(size=dec[k].shape)).astype(np.float32)
    got, want = both(dict(offset_value="mahalanobis"), src_g, dst_g, src_v,
                     dst_v, dec)
    eucl, _ = both(dict(offset_value="euclidean"), src_g, dst_g, src_v,
                   dst_v, dec)
    assert relerr(got["loss_offset"].item(),
                  float(want["loss_offset"])) <= 1e-5
    same = abs(got["loss_offset"].item() - eucl["loss_offset"].item()) \
        <= 1e-6 * abs(eucl["loss_offset"].item())
    assert same == (case != "small_scale"), case


@pytest.mark.parametrize("mode", ["euclidean", "manhattan", "mahalanobis"])
def test_gradients_match_jax(mode):
    """d loss / d (features, offsets) against jax.grad."""
    src_g, dst_g, src_v, dst_v, dec = loss_inputs(5)
    keys = list(FEATURES)
    cfg = dict(offset_value=mode, lambda_c=0.5, lambda_o=0.3)

    def jfn(*xs):
        d = dict(zip(keys, xs), pair_valid=jnp.asarray(dec["pair_valid"]))
        return jloss.registration_loss(
            jloss.LossConfig(**cfg), jnp.asarray(src_g), jnp.asarray(dst_g),
            jnp.asarray(src_v), jnp.asarray(dst_v), d)["loss"]

    want = jax.grad(jfn, argnums=tuple(range(len(keys))))(
        *(jnp.asarray(dec[k]) for k in keys))
    xs = {k: torch.from_numpy(dec[k]).requires_grad_(True) for k in keys}
    out = tloss.registration_loss(
        tloss.LossConfig(**cfg), torch.from_numpy(src_g),
        torch.from_numpy(dst_g), torch.from_numpy(src_v),
        torch.from_numpy(dst_v), dict(xs, pair_valid=torch.from_numpy(
            dec["pair_valid"])))
    out["loss"].backward()
    for k, w in zip(keys, want):
        g, w = xs[k].grad.numpy(), np.asarray(w)
        assert np.linalg.norm(w) > 0, k
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-4, k


def test_pairs_tie_to_the_first_index_and_neutral_logits_stay_finite():
    """Every dst point twice: the nearest is a tie, resolved to the first
    index as jnp.argmin does; the neutral mask (near but not nearest, so
    the twin) is equal, and the -1e8 logits keep the loss finite, also at
    a small tau."""
    src_g, dst_g, src_v, dst_v, dec = loss_inputs(6, D=36)
    dst_g[:, 18:] = dst_g[:, :18]
    dst_v[:] = True
    t = [torch.from_numpy(x) for x in (src_g, dst_g, src_v, dst_v)]
    ids, mask, neu = tloss.make_pairs(*t, 1.0)
    jids, jmask, jneu = jloss.make_pairs(*(jnp.asarray(x) for x in (
        src_g, dst_g, src_v, dst_v)), 1.0)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert np.array_equal(neu.numpy(), np.asarray(jneu))
    assert neu.any() and (ids.numpy() < 18)[mask.numpy()].all()
    for tau in (0.1, 0.01):
        got, want = both(dict(tau=tau), src_g, dst_g, src_v, dst_v, dec)
        assert np.isfinite(got["loss_coarse"].item())
        assert relerr(got["loss"].item(), float(want["loss"])) <= 1e-5


@pytest.mark.parametrize("b,m,n,k,p_near", [(2, 30, 20, 64, 0.3),
                                             (3, 8, 10, 64, 0.2),
                                             (1, 40, 40, 100, 0.9)])
def test_first_pairs_match_lax_top_k(b, m, n, k, p_near):
    """More near entries than k (the first k in flat order), fewer (the
    rest are the first far ones), all near."""
    near = np.random.default_rng(m).random((b, m, n)) < p_near
    vals, idx = jax.lax.top_k(jnp.asarray(near.reshape(b, -1), jnp.float32),
                              k)
    flat, valid = first_pairs(torch.from_numpy(near), k)
    assert np.array_equal(flat.numpy(), np.asarray(idx))
    assert np.array_equal(valid.numpy(), np.asarray(vals) > 0.5)


def tiny_decoder(seed: int = 0):
    """The decoder of tests/test_trainer.py's config, JAX and port, with
    the same parameters."""
    cfg = json.loads(json.dumps(train_args("/nonexistent")))
    jargs = train_args("/nonexistent")
    _, jdec, enc_p, dec_p = init_params(jargs, seed=seed)
    tdec = Decoder.from_config(config_from_dict(cfg))
    tdec.load_state_dict(state_dicts_from_jax(enc_p, dec_p)[1])
    return jdec, dec_p, tdec


@pytest.mark.parametrize("spread,max_pairs", [(1.5, 64), (1.5, 1440),
                                               (6.0, 64)])
def test_train_forward_matches_jax(spread, max_pairs):
    """Descriptors within a few meters: at spread 1.5 most of the 40 x 36
    pairs are within eps_offset, far more than 64; at max_pairs 1440 every
    pair is taken, valid or not; at spread 6 fewer are near."""
    jdec, dec_p, tdec = tiny_decoder()
    rng = np.random.default_rng(7)
    B, M, N, C = 2, 40, 36, 16
    src = rng.normal(size=(B, M, C + 3)).astype(np.float32)
    dst = rng.normal(size=(B, N, C + 3)).astype(np.float32)
    src[..., -3:] *= spread
    dst[..., -3:] *= spread
    sv, dv = rng.random((B, M)) > 0.1, rng.random((B, N)) > 0.1
    ang = rng.uniform(-0.3, 0.3, B)
    gt_R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]] for a in ang]).astype(np.float32)
    gt_t = rng.normal(0, 0.3, (B, 3)).astype(np.float32)
    want = jdec.apply(dec_p, *(jnp.asarray(x) for x in (src, dst, sv, dv,
                                                         gt_R, gt_t)),
                      max_pairs, method=JDecoder.train_forward)
    with torch.no_grad():
        got = tdec.train_forward(*(torch.from_numpy(x) for x in (
            src, dst, sv, dv, gt_R, gt_t)), max_pairs)
    valid = got["pair_valid"].numpy()
    assert np.array_equal(valid, np.asarray(want["pair_valid"]))
    near = int(valid.sum())
    if spread < 2 and max_pairs == 64:
        assert valid.all()                   # more near than max_pairs
    else:
        assert 0 < near < valid.size
    for k in FEATURES:
        assert relerr(got[k].numpy(), np.asarray(want[k])) <= 1e-4, k
