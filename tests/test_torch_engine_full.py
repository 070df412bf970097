"""The engine methods of the second slice against the JAX engine on the CPU:
`register`, multi-candidate registration, scan-to-map and map-to-map
registration on device-assembled tiles, `loop_scores_by_token`, the token
arguments of the fused odometry step with its lazy resolver, and the
token-keyed device cache (hits, evictions, invalidation).

Both engines get the weights the JAX package made, normalized inputs
(`upload_quant: none`, `bf16: false`, exact grades, information matrix at
stride 1) and the descriptors the JAX engine extracted, so every call sees
the same arrays. Tolerances are those of tests/test_torch_engine.py: R
within 0.01 deg, t within 1 mm, confidence and rmse within 1e-4, loop
probabilities within 1e-4 (float32 sums in another order). The information
matrix is held to relerr <= 5e-3: it sums over the ~1250 correspondences
within 1 m, and one on that boundary flips under a pose that differs in
its sixth digit.
"""

import numpy as np
import pytest
import torch

from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from tests.test_torch_engine import _check_pose, frames
from tests.test_torch_models import SMALL, jax_args
from tests.test_torch_ops import relerr

torch.set_num_threads(2)

CFG = dict(SMALL, tpu=dict(SMALL["tpu"], upload_quant="none", bf16=False,
                           neighbor_grade="exact", filter_grade="exact",
                           infomat_stride=1, loop_batch_buckets=[1, 2, 4]))
N_SCANS = 6


def make_engines(**tpu):
    cfg = dict(CFG, tpu=dict(CFG["tpu"], **tpu))
    enc, dec, enc_p, dec_p = init_params(jax_args(cfg), seed=2)
    j_eng = JEngine(jax_args(cfg), enc_p, dec_p, encoder=enc, decoder=dec)
    t_eng = InferenceEngine(config_from_dict(cfg),
                            *state_dicts_from_jax(enc_p, dec_p), device="cpu")
    return j_eng, t_eng


class Scan:
    """What the SLAM layer keeps of a scan: token, descriptors, point
    cloud in meters, validities, a pose."""

    def __init__(self, token, desc, kvalid, pcd, pvalid, pose):
        self.token, self.desc, self.kvalid = token, desc, kvalid
        self.pcd, self.pvalid, self.pose = pcd, pvalid, pose

    def member(self):
        return (self.token, self.desc, self.kvalid, self.pose)

    def cand(self):
        return (self.desc, self.kvalid, self.pcd, self.pvalid, self.token)


@pytest.fixture(scope="module")
def setup():
    """(JAX engine, port engine, N_SCANS scans with descriptors from the
    JAX engine and poses a few meters apart, their normalized points)."""
    j_eng, t_eng = make_engines()
    pts, valid = frames(N_SCANS)
    x = (pts / np.float32(60.0)).astype(np.float32)
    rng = np.random.default_rng(3)
    scans = []
    for i in range(N_SCANS):
        d, dv, pv = j_eng.extract(x[i:i + 1], valid[i:i + 1])
        pose = np.eye(4)
        a = 0.05 * i
        pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        pose[:3, 3] = [1.3 * i, rng.normal(0, 0.2), 0.0]
        scans.append(Scan(100 + i, np.asarray(d[0]), np.asarray(dv[0]),
                          pts[i], np.asarray(pv[0]), pose))
    return j_eng, t_eng, scans, (x, valid)


def _check_result(got, ref):
    _check_pose(got[0], ref[0])
    assert abs(got[1] - ref[1]) <= 1e-4 and abs(got[2] - ref[2]) <= 1e-4
    if len(ref) > 3:
        assert ref[3][3, 3] > 0 and relerr(got[3], ref[3]) <= 5e-3


def _same_cache(t_eng, j_eng, ordered=True):
    """Same keys in the same least-recently-used order, same byte count."""
    order = list if ordered else sorted
    assert order(t_eng._dcache) == order(j_eng._dcache)
    assert t_eng._dcache_bytes == j_eng._dcache_bytes


def test_register_matches_jax(setup):
    j_eng, t_eng, s, _ = setup
    args = (s[0].desc, s[0].kvalid, s[1].desc, s[1].kvalid)
    _check_result(t_eng.register(*args), j_eng.register(*args))


def test_register_with_info_tokens_fill_the_cache(setup):
    j_eng, t_eng, s, _ = setup
    for eng in (j_eng, t_eng):
        eng.invalidate_device_cache()
    args = (s[0].desc, s[0].kvalid, s[1].desc, s[1].kvalid, s[0].pcd,
            s[0].pvalid, s[1].pcd, s[1].pvalid)
    kw = dict(src_token=s[0].token, dst_token=s[1].token)
    _check_result(t_eng.register_with_info(*args, **kw),
                  j_eng.register_with_info(*args, **kw))
    _same_cache(t_eng, j_eng)
    assert (s[0].token, "pcd") in t_eng._dcache


def test_register_with_info_multi_matches_jax(setup):
    """Three candidates (padded to a bucket of four in the JAX package)
    against one scan: one resolver each, equal to the JAX results and to
    the single-candidate call."""
    j_eng, t_eng, s, _ = setup
    for eng in (j_eng, t_eng):
        eng.invalidate_device_cache()
    dst = s[4]
    call = lambda eng: eng.register_with_info_multi_async(
        [x.cand() for x in s[:3]], dst.desc, dst.kvalid, dst.pcd, dst.pvalid,
        num_sample=0.5, dst_token=dst.token)
    got, ref = call(t_eng), call(j_eng)
    assert len(got) == len(ref) == 3
    for g, r, x in zip(got, ref, s):
        g = g()
        _check_result(g, r())
        single = t_eng.register_with_info(x.desc, x.kvalid, dst.desc,
                                          dst.kvalid, x.pcd, x.pvalid,
                                          dst.pcd, dst.pvalid)
        _check_result(g, single)
    # the JAX engine touches the first candidate once more, for the padding
    # of the candidate count to its bucket; the port touches it the same way
    _same_cache(t_eng, j_eng, ordered=True)
    # cached candidates are served without touching their thunks
    boom = lambda: 1 / 0
    again = t_eng.register_with_info_multi_async(
        [(boom, x.kvalid, boom, boom, x.token) for x in s[:3]], dst.desc,
        dst.kvalid, boom, boom, dst_token=dst.token)
    _check_result(again[1](), ref[1]())
    with pytest.raises(ValueError):
        t_eng.register_with_info_multi_async([], dst.desc, dst.kvalid,
                                             dst.pcd, dst.pvalid)


def test_multi_candidate_padding_evicts_like_jax(setup):
    """A budget that just holds the three candidates: the padded fourth slot
    touches candidate 0 again, so the new scan's point cloud pushes
    candidate 1 out first, in both engines."""
    _, t_big, s, _ = setup
    t_big.invalidate_device_cache()
    t_big._scan_dev(*s[0].cand())
    per_scan = t_big._dcache_bytes
    t_big.invalidate_device_cache()
    j_eng, t_eng = make_engines(device_cache_mb=3.05 * per_scan / 2 ** 20)
    dst = s[4]
    for eng in (j_eng, t_eng):
        eng.register_with_info_multi_async(
            [x.cand() for x in s[:3]], dst.desc, dst.kvalid, dst.pcd,
            dst.pvalid, num_sample=0.5, dst_token=dst.token)
    _same_cache(t_eng, j_eng, ordered=True)
    assert (s[0].token, "kp_pad") in t_eng._dcache
    assert (s[1].token, "kp_pad") not in t_eng._dcache
    assert (dst.token, "pcd") in t_eng._dcache


@pytest.mark.parametrize("n_members", [3, 5])
def test_scan_to_map_matches_jax(setup, n_members):
    """A tile of 3 (bucket 4) or 5 (bucket 8) keyframes assembled on the
    device, registered against a new scan."""
    j_eng, t_eng, s, _ = setup
    for eng in (j_eng, t_eng):
        eng.invalidate_device_cache()
    members, dst = [x.member() for x in s[:n_members]], s[5]
    call = lambda eng: eng.register_scan_to_map_with_info_async(
        members, s[1].pose, dst.desc, dst.kvalid, s[1].pcd, s[1].pvalid,
        dst.pcd, dst.pvalid, num_sample=0.5, src_token=s[1].token,
        dst_token=dst.token)()
    _check_result(call(t_eng), call(j_eng))
    _same_cache(t_eng, j_eng)


def test_map_to_map_matches_jax(setup):
    j_eng, t_eng, s, _ = setup
    for eng in (j_eng, t_eng):
        eng.invalidate_device_cache()
    call = lambda eng: eng.register_map_to_map_with_info_async(
        [x.member() for x in s[:3]], s[1].pose,
        [x.member() for x in s[3:]], s[4].pose, s[1].pcd, s[1].pvalid,
        s[4].pcd, s[4].pvalid, num_sample=0.5, src_token=s[1].token,
        dst_token=s[4].token)()
    _check_result(call(t_eng), call(j_eng))
    _same_cache(t_eng, j_eng)


def test_tile_members_are_bucketed_and_cropped(setup):
    """More members than the largest bucket: the nearest ones are kept, as
    in the JAX engine; the relative poses are equal."""
    j_eng, t_eng, s, _ = setup
    many = [x.member() for x in s] * 3                      # 18 > 16
    gm, gp, gv = t_eng._pad_members(many, s[2].pose)
    rm, rp, rv = j_eng._pad_members(many, s[2].pose)
    assert [m[0] for m in gm] == [m[0] for m in rm[:len(gm)]]
    np.testing.assert_array_equal(gp, rp)
    np.testing.assert_array_equal(gv, rv)
    assert len(gv) == 16 and gv.all()
    _, gp, gv = t_eng._pad_members(many[:5], s[2].pose)
    assert len(gv) == 8 and gv.sum() == 5


def test_loop_scores_by_token_matches_jax(setup):
    """Six candidates in chunks of the largest batch bucket (4 + 2)."""
    j_eng, t_eng, s, _ = setup
    for eng in (j_eng, t_eng):
        eng.invalidate_device_cache()
    members = [(x.token, x.desc, x.kvalid) for x in s]
    new = s[2]
    call = lambda eng: eng.loop_scores_by_token(members, new.desc,
                                                new.kvalid,
                                                new_token=new.token)
    got, ref = call(t_eng), np.asarray(call(j_eng))
    assert got.shape == ref.shape == (6,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    _same_cache(t_eng, j_eng)
    stacked = t_eng.loop_scores(
        np.stack([x.desc for x in s]), np.repeat(new.desc[None], 6, 0),
        np.stack([x.kvalid for x in s]), np.repeat(new.kvalid[None], 6, 0))
    np.testing.assert_allclose(got, stacked, rtol=0, atol=1e-5)
    assert t_eng.loop_scores_by_token([], new.desc, new.kvalid).shape == (0,)


def test_odometry_tokens_and_lazy_resolver_match_jax(setup):
    """With `new_token` the resolver returns thunks for the descriptors and
    the point validity and both scans sit in the cache; the next step takes
    its candidate from there without calling its thunks."""
    j_eng, t_eng, s, (x, valid) = setup
    for eng in (j_eng, t_eng):
        eng.invalidate_device_cache()
    c = s[0]
    step = lambda eng: eng.odometry_step_async(
        x[1:2], valid[1:2], c.desc, c.kvalid, c.pcd, c.pvalid,
        cand_token=c.token, new_token=777)()
    got, ref = step(t_eng), step(j_eng)
    assert callable(got[0]) and callable(got[2])
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2](), np.asarray(ref[2]()))
    assert relerr(got[0](), np.asarray(ref[0]())) <= 5e-4
    _check_result(got[3:], ref[3:])
    _same_cache(t_eng, j_eng)

    eager = t_eng.odometry_step(x[1:2], valid[1:2], c.desc, c.kvalid, c.pcd,
                                c.pvalid, cand_token=c.token)
    np.testing.assert_array_equal(eager[0][0], got[0]())
    np.testing.assert_array_equal(eager[3], got[3])

    boom = lambda: 1 / 0
    nxt = lambda eng: eng.odometry_step_async(
        x[2:3], valid[2:3], boom, np.asarray(ref[1]), boom, boom,
        cand_token=777, new_token=778)()
    _check_result(nxt(t_eng)[3:], nxt(j_eng)[3:])
    _same_cache(t_eng, j_eng)


def test_device_cache_budget_evicts_like_jax():
    """A budget that holds about two scans: the least recently used entries
    go, in the JAX engine's order; invalidation drops one token or all."""
    j_eng, t_eng = make_engines(device_cache_mb=0.1)
    rng = np.random.default_rng(0)
    for eng in (j_eng, t_eng):
        for tok in range(5):
            pcd = rng.normal(size=(2048, 3)).astype(np.float32)
            eng._dev(pcd, (tok, "pcd"))
            eng._dev(np.ones(2048, bool), (tok, "pv"))
            eng._dev(pcd, (0, "pcd")) if tok == 2 else None
        rng = np.random.default_rng(0)
    _same_cache(t_eng, j_eng)
    assert 0 < t_eng._dcache_bytes <= t_eng._dcache_budget
    assert (4, "pcd") in t_eng._dcache and (1, "pcd") not in t_eng._dcache
    assert t_eng._dcache_probe(4, ("pcd", "pv")) is not None
    assert t_eng._dcache_probe(4, ("pcd", "kp_pad")) is None
    assert t_eng._dcache_probe(None, ("pcd",)) is None
    for eng in (j_eng, t_eng):
        eng.invalidate_device_cache(4)
    _same_cache(t_eng, j_eng)
    assert (4, "pcd") not in t_eng._dcache
    t_eng.invalidate_device_cache()
    assert not t_eng._dcache and t_eng._dcache_bytes == 0
