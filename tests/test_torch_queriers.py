"""The encoder's remaining options, port against the JAX package on the CPU:
voxel-grid sampling (`sample: {type: voxel}`), the ball query and the knn /
ball queriers (`encoder.querier`), on the same numpy inputs and, for the
encoder, the same random weights (carried across by state_dicts_from_jax).

voxel_sample and ball_query are index computations: their indices must be
equal, ties and out-of-range points included. The encoder's descriptors
are held to test_torch_models.py's bar (relerr <= 5e-4: float32 matmul
rounding), coordinates and validity exactly.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.models.encoder import Encoder as JEncoder
from deeppointmap_tpu.ops import neighbors as jnb
from deeppointmap_tpu.ops import sampling as jsampling
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.ops import neighbors as tnb
from deeppointmap_tpu_torch.ops import sampling as tsampling
from tests.test_torch_models import SMALL, _inputs, jax_args
from tests.test_torch_ops import relerr

torch.set_num_threads(2)


def _cloud(seed: int, n: int = 600):
    """Points in [-1.3, 1.3]^3 (some beyond a unit sample range), a tenth
    invalid, a quarter of them duplicates of others (equal distances to
    their voxel centers)."""
    g = np.random.default_rng(seed)
    xyz = g.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    dup = g.choice(n, n // 4, replace=False)
    xyz[dup] = xyz[g.choice(n, n // 4)]
    valid = g.random(n) >= 0.1
    return xyz, valid


@pytest.mark.parametrize("seed,k,voxel_size,sample_range", [
    (0, 48, 0.25, 1.0), (1, 128, 0.1, 1.0), (2, 64, 0.3, 1.0),
    (3, 500, 0.05, 1.2), (4, 32, 0.5, 0.8)])
def test_voxel_sample_matches_jax(seed, k, voxel_size, sample_range):
    """Indices and sel_valid equal, with voxels of equal counts (ranked by
    their first position) and more slots than voxels in some cases."""
    xyz, valid = _cloud(seed)
    ji, jv = (np.asarray(x) for x in jsampling.voxel_sample(
        jnp.asarray(xyz), jnp.asarray(valid), k, voxel_size, sample_range))
    ti, tv = tsampling.voxel_sample(torch.from_numpy(xyz),
                                    torch.from_numpy(valid), k, voxel_size,
                                    sample_range)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert jv.any()


def test_batched_voxel_sample_matches_jax():
    clouds = [_cloud(s) for s in (5, 6)]
    xyz = np.stack([c[0] for c in clouds])
    valid = np.stack([c[1] for c in clouds])
    j = [np.asarray(x) for x in jsampling.batched_voxel_sample(
        jnp.asarray(xyz), jnp.asarray(valid), 96, 0.2, 1.0)]
    t = [x.numpy() for x in tsampling.batched_voxel_sample(
        torch.from_numpy(xyz), torch.from_numpy(valid), 96, 0.2, 1.0)]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,k,radius", [(0, 8, 0.3), (1, 16, 0.5),
                                           (2, 4, 0.05), (3, 32, 2.0)])
def test_ball_query_matches_jax(seed, k, radius):
    """Indices equal, with balls holding fewer than k points (self-fill)
    and empty ones (centers away from every valid point)."""
    xyz, valid = _cloud(seed)
    g = np.random.default_rng(seed + 10)
    centers = np.concatenate([xyz[:40], g.uniform(-4, 4, (9, 3))]).astype(
        np.float32)
    j = np.asarray(jnb.ball_query(jnp.asarray(xyz), jnp.asarray(centers), k,
                                  radius, jnp.asarray(valid)))
    t = tnb.ball_query(torch.from_numpy(xyz)[None],
                       torch.from_numpy(centers)[None], k, radius,
                       torch.from_numpy(valid)[None], center_chunk=16)
    np.testing.assert_array_equal(t[0].numpy(), j)


def _config(sample=None, querier=None):
    cfg = copy.deepcopy(SMALL)
    if sample is not None:
        cfg["encoder"]["sample"] = sample
    if querier is not None:
        cfg["encoder"]["querier"] = querier
    return cfg


VOXEL = [{"type": "voxel", "size": 0.02, "range": 1.0}, {"type": "fps"},
         {"type": "voxel", "size": 0.05, "range": 1.0}]


@pytest.mark.parametrize("sample,querier", [
    (VOXEL, None), (None, "knn"), (None, "ball"), (None, "hybrid-t3d"),
    (VOXEL, "ball")], ids=["voxel", "knn", "ball", "hybrid-t3d",
                           "voxel_ball"])
def test_encoder_options_match_jax(sample, querier):
    """The encoder with each sampler / querier: coordinates and validity
    equal, descriptors relerr <= 5e-4."""
    cfg = _config(sample, querier)
    enc, _, enc_p, dec_p = init_params(jax_args(cfg), seed=0)
    t_enc = Encoder.from_config(config_from_dict(cfg))
    t_enc.load_state_dict(state_dicts_from_jax(enc_p, dec_p)[0])
    t_enc.eval()
    pts, valid = _inputs()
    jc, jf, jv = (np.asarray(x) for x in enc.apply(enc_p, jnp.asarray(pts),
                                                   jnp.asarray(valid)))
    with torch.no_grad():
        tc, tf, tv = (x.numpy() for x in t_enc(torch.from_numpy(pts),
                                               torch.from_numpy(valid)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    assert relerr(tf, jf) <= 5e-4


def test_from_config_accepts_what_jax_accepts():
    """Samplers fps / fps-t3d / voxel and queriers knn / ball / hybrid
    (with their -t3d spellings) build; an unknown one raises in both
    packages."""
    for q in ("knn", "ball-t3d", "hybrid", "HYBRID-T3D"):
        cfg = _config(VOXEL[:1] * 3, q)
        t = Encoder.from_config(config_from_dict(cfg))
        j = JEncoder.from_config(jax_args(cfg))
        assert t.querier == j.querier
    for bad in (_config(querier="radius"),
                _config(sample=[{"type": "random"}] * 3)):
        with pytest.raises(ValueError):
            Encoder.from_config(config_from_dict(bad))
        with pytest.raises(ValueError):
            JEncoder.from_config(jax_args(bad))
