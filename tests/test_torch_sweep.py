"""K3 and K4's plain versions, the `filter_sweep` routing and the sweep-reuse
path of the port against the JAX package on the CPU.

The Pallas kernels run in interpret mode. They round d2 differently from
the port (a HIGHEST matmul against single-rounded operations), so a point on
the radius boundary or two candidates a last bit apart can land on the other
side: moments are held to the JAX tests' own tolerances (rtol 1e-6, atol
1e-4 for s and 1e-2 for S6) with cnt equal on >= 99.9% of the rows, and
neighbour SETS must be equal on >= 99.9% of the rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.data.preprocess import PreprocessConfig as JPre
from deeppointmap_tpu.data.preprocess import preprocess as j_preprocess
from deeppointmap_tpu.models import encoder as jenc
from deeppointmap_tpu.ops import neighbors as jnb
from deeppointmap_tpu.ops import normals as jnormals
from deeppointmap_tpu.ops.pallas_moments import radius_moments_pallas
from deeppointmap_tpu.ops.pallas_sweep import fused_sweep_pallas
from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig as TPre
from deeppointmap_tpu_torch.data.preprocess import preprocess
from deeppointmap_tpu_torch.models import encoder as tenc
from deeppointmap_tpu_torch.ops import neighbors as tnb
from deeppointmap_tpu_torch.ops import normals as tnormals
from deeppointmap_tpu_torch.ops import sweep

torch.set_num_threads(2)


def cloud(n, n_valid, seed, scale=8.0):
    g = np.random.default_rng(seed)
    pts = g.uniform(-scale, scale, (n, 3)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[g.permutation(n)[:n_valid]] = True
    return pts, valid


def t(x):
    return torch.from_numpy(np.asarray(x))[None]


def _check_moments(got, ref, valid):
    cnt, s, S6 = (x[0].numpy() for x in got)
    cnt_j, s_j, S6_j = (np.asarray(x) for x in ref)
    same = cnt == cnt_j
    assert same.mean() >= 0.999
    np.testing.assert_allclose(s[same], s_j[same], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(S6[same], S6_j[same], rtol=1e-6, atol=1e-2)
    assert (cnt[valid] >= 1).all()


@pytest.mark.parametrize("n,n_valid,radius", [(2048, 1700, 1.5),
                                              (4096, 3000, 1.0)])
def test_radius_moments_plain_matches_pallas(n, n_valid, radius):
    pts, valid = cloud(n, n_valid, n)
    ref = radius_moments_pallas(jnp.asarray(pts), jnp.asarray(valid), radius,
                                interpret=True)
    _check_moments(sweep.radius_moments(t(pts), t(valid), radius), ref, valid)


@pytest.mark.parametrize("n,n_valid,k,radius", [(2048, 1700, 17, 1.5),
                                                (4096, 3000, 41, 0.0)])
def test_fused_sweep_plain_matches_pallas(n, n_valid, k, radius):
    """Neighbour sets of the valid centers equal on >= 99.9% of the rows,
    distances of equal rows within 1e-4 (d2 is rounded differently), and
    the moments as K3's."""
    pts, valid = cloud(n, n_valid, n + k)
    ref = fused_sweep_pallas(jnp.asarray(pts), jnp.asarray(valid), k, radius,
                             interpret=True)
    got = sweep.fused_sweep(t(pts), t(valid), k, radius)
    idx, d2 = got[0][0].numpy(), got[1][0].numpy()
    idx_j, d2_j = np.asarray(ref[0]), np.asarray(ref[1])
    same = np.all(np.sort(idx, 1) == np.sort(idx_j, 1), axis=1)
    assert same[valid].mean() >= 0.999
    rows = same & valid
    np.testing.assert_allclose(d2[rows], d2_j[rows], rtol=1e-5, atol=1e-4)
    assert (np.diff(d2, axis=1) >= 0).all()
    if radius > 0:
        _check_moments(got[2:], ref[2:], valid)


def test_fused_sweep_plain_odd_shape():
    """N not a multiple of 128 and fewer valid points than k: in-range
    indices, the valid points first, then the 1e9 sentinel."""
    pts, valid = cloud(300, 9, 3)
    idx, d2 = (x[0].numpy() for x in sweep.fused_sweep(t(pts), t(valid), 12))
    assert idx.min() >= 0 and idx.max() < 300
    assert (d2[:, :9] < 1e8).all() and (d2[:, 9:] == 1e9).all()
    np.testing.assert_array_equal(np.sort(idx[:, :9], 1),
                                  np.tile(np.nonzero(valid)[0], (300, 1)))
    exact = tnb.knn_plain(t(pts), t(pts), 9, t(valid))
    np.testing.assert_array_equal(idx[:, :9], exact[0][0].numpy())
    np.testing.assert_array_equal(d2[:, :9], exact[1][0].numpy())


def test_fused_sweep_recall_against_exact():
    """The JAX contract (tests/test_pallas_sweep.py): recall >= 0.97."""
    pts, valid = cloud(4096, 3500, 5)
    for k in (17, 41):
        approx = sweep.fused_sweep(t(pts), t(valid), k)[0][0].numpy()
        exact = tnb.knn(t(pts), t(pts), k, t(valid))[0][0].numpy()
        recall = np.mean([len(np.intersect1d(a, e)) / k
                          for a, e in zip(approx[valid], exact[valid])])
        assert recall >= 0.97, (k, recall)


def test_filter_sweep_routing(monkeypatch):
    """Each switch sends `filter_sweep` to its kernel's wrapper, with the
    JAX package's precedence; k = 0 always takes K3."""
    pts, valid = cloud(600, 500, 9)
    p, v = t(pts), t(valid)
    calls = []
    for mod, name in ((tnormals, "knn"), (tnormals, "fused_sweep"),
                      (tnormals, "radius_moments")):
        def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)

    base = tnormals.filter_sweep(p, v, 17, 1.0)
    assert calls == ["knn"] and len(base) == 5
    calls.clear()
    moments_only = tnormals.filter_sweep(p, v, 0, 1.0)
    assert calls == ["radius_moments"] and len(moments_only) == 3

    monkeypatch.setattr(tnormals, "USE_FUSED_MOMENTS", True)
    calls.clear()
    out = tnormals.filter_sweep(p, v, 17, 1.0)
    assert calls == ["radius_moments", "knn"] and len(out) == 5
    for a, b in zip(out[:2], base[:2]):          # K2's graph, unchanged
        assert torch.equal(a, b)
    assert torch.equal(out[2], base[2])          # same membership
    np.testing.assert_allclose(out[4].numpy(), base[4].numpy(), rtol=1e-5,
                               atol=1e-3)
    calls.clear()
    assert len(tnormals.filter_sweep(p, v, 17, 0.0)) == 2
    assert calls == ["knn"]

    monkeypatch.setattr(tnormals, "USE_FUSED_SWEEP", True)   # wins over K3
    calls.clear()
    out = tnormals.filter_sweep(p, v, 17, 1.0)
    assert calls == ["fused_sweep"] and len(out) == 5
    assert torch.equal(out[2], base[2])
    calls.clear()
    tnormals.filter_sweep(p, v, 0, 1.0)
    assert calls == ["radius_moments"]
    calls.clear()
    tnormals.filter_sweep(p, v, 200, 1.0)        # beyond K4's k
    assert calls == ["radius_moments", "knn"]
    with pytest.raises(ValueError):
        tnormals.filter_sweep(p, v, 0, 0.0)


def test_radius_normals_match_jax():
    """Normals by PCA over all points in the radius: |cos| >= 1 - 1e-4
    against the JAX package on >= 97% of the valid points with more than
    two neighbours (float32 moments lose precision in the JAX package)."""
    pts, valid = cloud(2048, 1800, 21, scale=5.0)
    ref = np.asarray(jnormals.radius_normals(jnp.asarray(pts),
                                             jnp.asarray(valid), 1.0))
    got = tnormals.radius_normals(t(pts), t(valid), 1.0)[0].numpy()
    cnt = sweep.radius_moments(t(pts), t(valid), 1.0)[0][0].numpy()
    keep = valid & (cnt > 2)
    cos = np.abs(np.sum(got * ref, -1))[keep]
    assert np.mean(cos >= 1 - 1e-4) >= 0.97
    assert np.all(got[cnt <= 2] == [0, 0, 1])


# ------------------------------------------------------- sweep reuse
def test_group_from_sweep_matches_jax():
    """Same candidates, same final validity, same centers: identical
    groups (mirrors tests/test_sweep_reuse.py)."""
    n, ks, k, radius = 256, 24, 16, 4.0
    pts, _ = cloud(n, n, 0, scale=10.0)
    valid_pre = np.arange(n) < n - 16
    cand_idx, cand_d2 = jnb.knn(jnp.asarray(pts), jnp.asarray(pts), ks,
                                jnp.asarray(valid_pre))
    keep = np.ones(n, bool)
    keep[np.random.RandomState(1).choice(n, n // 20, replace=False)] = False
    center_idx = np.where(keep & valid_pre)[0][::3][:64][None]
    ref = jenc._group_from_sweep(
        jnp.asarray(center_idx), jnp.asarray(keep)[None],
        (cand_idx[None], cand_d2[None]), k, radius)
    got = tenc._group_from_sweep(
        torch.from_numpy(center_idx), t(keep),
        (t(cand_idx).long(), t(cand_d2)), k, radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert keep[got.numpy()].all() and valid_pre[got.numpy()].all()


TRANSFORMS = {
    "DistanceSample": {"min_dis": 1.0, "max_dis": 60.0},
    "OutlierFilter": {"nb_neighbors": 10, "std_ratio": 3.0},
    "CoordinatesNormalization": {"ratio": 60.0},
}


def test_preprocess_sweep_matches_jax():
    """preprocess(sweep_k > 0): the same survivors and normalized points,
    the same candidate sets, dist2 in normalized units within 1e-6 (the
    rounding of |c|^2 - 2 c.p + |p|^2 at +-30 m, over ratio^2), the
    sentinel pinned at 1e9."""
    pts, valid = cloud(1024, 900, 4, scale=30.0)
    ref = j_preprocess(jnp.asarray(pts), jnp.asarray(valid),
                       JPre.from_transforms(TRANSFORMS,
                                            neighbor_grade="exact",
                                            sweep_k=24))
    got = preprocess(t(pts), t(valid),
                     TPre.from_transforms(TRANSFORMS, sweep_k=24))
    assert len(got) == len(ref) == 3
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1]))
    idx, d2 = got[2][0][0].numpy(), got[2][1][0].numpy()
    idx_j, d2_j = np.asarray(ref[2][0]), np.asarray(ref[2][1])
    assert idx.shape == idx_j.shape == (1024, 24)
    real = d2_j < 1e8
    np.testing.assert_array_equal(d2 < 1e8, real)
    assert (d2[~real] == 1e9).all() and d2[real].max() < 4.0
    same = np.all(np.sort(idx, 1) == np.sort(idx_j, 1), axis=1)
    crop = np.asarray(ref[1]) | (np.linalg.norm(pts, axis=1) <= 60.0)
    assert same[crop].mean() >= 0.999
    np.testing.assert_allclose(d2[real & same[:, None]],
                               d2_j[real & same[:, None]], rtol=1e-4,
                               atol=1e-6)


def test_preprocess_with_fused_sweep_keeps_the_survivors(monkeypatch):
    """Under USE_FUSED_SWEEP (K4's approximate neighbours, float64 moments)
    the full filter chain keeps the survivors of the default route but for
    <= 1% of the points, and returns the widened candidate graph."""
    from tests.test_torch_ops import TRANSFORMS as FULL
    from tests.test_torch_ops import scan

    pts, valid = scan(7)
    cfg = TPre.from_transforms(FULL, sweep_k=41)
    base = preprocess(t(pts), t(valid), cfg)
    monkeypatch.setattr(tnormals, "USE_FUSED_SWEEP", True)
    got = preprocess(t(pts), t(valid), cfg)
    assert torch.equal(got[0], base[0])
    diff = (got[1] != base[1]).sum().item()
    assert diff <= 0.01 * valid.sum(), diff
    assert got[2][0].shape == (1, len(pts), 41)
    assert got[2][0].dtype == torch.int64


def test_encoder_with_sweep_matches_without():
    """When the filters drop nothing after the sweep, the encoder served
    from the sweep's exact candidates equals the encoder with its own
    stage-1 query (as tests/test_sweep_reuse.py holds for the JAX one)."""
    from tests.test_torch_models import SMALL
    from deeppointmap_tpu_torch.config import config_from_dict

    torch.manual_seed(0)
    enc = tenc.Encoder.from_config(config_from_dict(SMALL)).eval()
    pts, valid = cloud(1024, 900, 6, scale=0.5)
    p, v = t(pts), t(valid)
    k = enc.nsample_list[0][0] + 9
    with torch.inference_mode():
        graph = tnb.knn(p, p, k, v)
        ref = enc(p, v)
        got = enc(p, v, sweep=graph)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ------------------------------------------------ K4's rule, restated
def _seam_cloud(n, seed, dup=False):
    """A scan with the seams of K4's layout: scattered validity, a run of
    invalid points in the middle, a few classes with fewer than two valid
    points (classes 5 and 77 keep at most one), and, with `dup`, every
    point twice (distance ties across classes)."""
    g = np.random.default_rng(seed)
    pts = g.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    if dup:
        pts[n // 2:] = pts[:n - n // 2]
    valid = g.random(n) < 0.6
    valid[n // 3:n // 3 + 150] = False
    cls = np.arange(n) % 128
    valid[(cls == 5) | (cls == 77)] = False
    valid[5] = True
    return pts, valid


U31, U32 = np.uint64(31), np.uint64(32)
LOW = np.uint64(0xFFFFFFFF)


def _mono(d):
    """Order-preserving unsigned bits of float32 values, as uint64."""
    u = np.asarray(d, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u >> U31 == 1, u ^ np.uint64(0xFFFFFFFF),
                    u | np.uint64(0x80000000))


def _keys(pts, valid):
    """(n, n_pad) 64-bit keys (distance bits, then the index) of every
    center against the scan padded to n_pad, invalid points and padding at
    1e9; and n_pad."""
    n = len(pts)
    n_pad = max(256, -(-n // 128) * 128)
    d = tnb.pairwise_dist2(t(pts), t(pts))[0].numpy()
    d = np.where(valid[None], d, np.float32(1e9))
    d = np.pad(d, ((0, 0), (0, n_pad - n)), constant_values=np.float32(1e9))
    return (_mono(d) << U32) | np.arange(n_pad, dtype=np.uint64)[None], n_pad


def _decode(keys, n):
    d = (keys >> U32).astype(np.uint32)
    d = np.where(d >> 31 == 1, d ^ np.uint32(0x80000000), ~d).astype(
        np.uint32)
    return np.minimum((keys & LOW).astype(np.int64), n - 1), \
        d.view(np.float32)


@pytest.mark.parametrize("n,k,dup", [(777, 17, False), (777, 41, True),
                                     (300, 128, False), (1000, 1, True)])
def test_fused_sweep_plain_is_the_class_rule(n, k, dup):
    """fused_sweep_plain against a second statement of K4's rule: walk a
    center's keys in ascending order and take each one unless its
    index-mod-128 class has given two already; the first k taken, in order,
    are the neighbours (indices clamped to n - 1). Bit for bit."""
    pts, valid = _seam_cloud(n, n + k, dup)
    keys, _ = _keys(pts, valid)
    order = np.sort(keys, axis=1)
    want = np.empty((n, k), np.uint64)
    for c in range(n):
        per_class, taken = np.zeros(128, int), 0
        for key in order[c]:
            cls = int(key & 0xFFFFFFFF) % 128
            if per_class[cls] < 2:
                per_class[cls] += 1
                want[c, taken] = key
                taken += 1
                if taken == k:
                    break
    idx, d2 = (x[0].numpy() for x in sweep.fused_sweep(t(pts), t(valid), k))
    w_idx, w_d2 = _decode(want, n)
    np.testing.assert_array_equal(idx, w_idx)
    np.testing.assert_array_equal(d2.view(np.uint32), w_d2.view(np.uint32))


# ------------------------------------------------ model of sweep.cu
#: csrc/sweep.cu sort_pairs8: Batcher's odd-even merge sort of eight
#: without its first layer (the pairs come sorted)
SORT_PAIRS8 = [(0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6), (0, 4),
               (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2), (3, 4),
               (5, 6)]
KMAX = np.iinfo(np.uint64).max


def _merge_halves(o, length):
    """csrc/sweep.cu merge_halves: the mirror layer, then half-cleaners."""
    ces = [(o + i, o + length - 1 - i) for i in range(length // 2)]
    st = length // 4
    while st > 0:
        ces += [(o + i, o + i + st) for i in range(length) if not i & st]
        st //= 2
    return ces


#: a lane's network: four runs of eight from sorted pairs, merged to 32
LANE_NETWORK = ([(a + o, b + o) for o in (0, 8, 16, 24)
                 for a, b in SORT_PAIRS8]
                + _merge_halves(0, 16) + _merge_halves(16, 16)
                + _merge_halves(0, 32))


def _run(network, v):
    v = list(v)
    for a, b in network:
        if v[a] > v[b]:
            v[a], v[b] = v[b], v[a]
    return v


def test_sort_networks_sort():
    """0-1 principle: sort_pairs8 sorts every 0/1 input whose pairs are
    sorted, and merge_halves merges every pair of sorted 0/1 halves, so
    both do so for keys; the lane's whole network then sorts 32 keys given
    as 16 sorted pairs (random keys, with repeats)."""
    for bits in range(256):
        v = [(bits >> i) & 1 for i in range(8)]
        if all(v[2 * q] <= v[2 * q + 1] for q in range(4)):
            assert _run(SORT_PAIRS8, v) == sorted(v), bits
    for length in (16, 32):
        h = length // 2
        for z0 in range(h + 1):
            for z1 in range(h + 1):
                v = [0] * z0 + [1] * (h - z0) + [0] * z1 + [1] * (h - z1)
                assert _run(_merge_halves(0, length), v) == sorted(v)
    g = np.random.default_rng(0)
    for _ in range(200):
        v = np.sort(g.integers(0, 40, (16, 2)), axis=1).ravel().tolist()
        assert _run(LANE_NETWORK, v) == sorted(v)


def _sweep_model(pts, valid, k):
    """numpy model of csrc/sweep.cu for one scan, vectorized over centers:
    pack_classes (valid points compacted per class in index order, the two
    lowest invalid indices), the best two of each class by strict "less
    than" in slot order, the merge with the invalid keys at the class end,
    each of a center's 8 lanes sorting its 16 classes' pairs by
    LANE_NETWORK, and the k-round tournament over the 8 lanes' heads."""
    n = len(pts)
    n_pad = max(256, -(-n // 128) * 128)
    d = tnb.pairwise_dist2(t(pts), t(pts))[0].numpy()
    key1e9 = int(_mono(np.float32(1e9))) << 32
    cand = np.empty((n, 256), np.uint64)
    for j in range(128):
        members = np.arange(j, n_pad, 128)
        ok = (members < n) & valid[np.minimum(members, n - 1)]
        slots, inv = members[ok], members[~ok][:2]
        b1d = np.full(n, np.inf, np.float32)
        b2d = b1d.copy()
        b1t = np.full(n, -1)
        b2t = b1t.copy()
        for s, p in enumerate(slots):
            e = d[:, p]
            lt1, lt2 = e < b1d, e < b2d
            b2d, b2t = (np.where(lt1, b1d, np.where(lt2, e, b2d)),
                        np.where(lt1, b1t, np.where(lt2, s, b2t)))
            b1d, b1t = np.where(lt1, e, b1d), np.where(lt1, s, b1t)

        def valid_key(bd, bt):
            idx = slots[np.maximum(bt, 0)] if len(slots) else 0
            return np.where(bt >= 0, (_mono(bd) << U32)
                            | np.asarray(idx, np.uint64), KMAX)

        kv0, kv1 = valid_key(b1d, b1t), valid_key(b2d, b2t)
        ki0, ki1 = (np.uint64(key1e9 | int(inv[i]) if i < len(inv)
                              else KMAX) for i in range(2))
        cand[:, 2 * j] = np.minimum(kv0, ki0)
        cand[:, 2 * j + 1] = np.where(kv0 < ki0, np.minimum(kv1, ki0),
                                      np.minimum(kv0, ki1))
    # a group of 8 lanes a center; lane `sub` sorts the pairs of classes
    # sub + 8 i (i < 16) by LANE_NETWORK
    runs = np.stack([cand[:, [2 * (sub + 8 * (e // 2)) + e % 2
                              for e in range(32)]] for sub in range(8)], 1)
    for a, b in LANE_NETWORK:
        lo = np.minimum(runs[..., a], runs[..., b])
        runs[..., b] = np.maximum(runs[..., a], runs[..., b])
        runs[..., a] = lo
    assert (runs[..., 1:] > runs[..., :-1]).all()
    # k rounds: the group's smallest head; its lane advances
    taken = np.zeros((n, 8), int)
    rows = np.arange(n)
    out = np.empty((n, k), np.uint64)
    for i in range(k):
        heads = np.where(taken < 32, np.take_along_axis(
            runs, np.minimum(taken, 31)[..., None], 2)[..., 0], KMAX)
        win = np.argmin(heads, axis=1)
        out[:, i] = heads[rows, win]
        taken[rows, win] += 1
    return _decode(out, n)


@pytest.mark.parametrize("n,k,dup", [(777, 41, True), (1000, 17, False),
                                     (200, 128, False), (130, 1, True)])
def test_sweep_kernel_model_matches_plain(n, k, dup):
    """The algorithm of csrc/sweep.cu, modelled in numpy, gives the plain
    version's indices and distances bit for bit on the layout's seams."""
    pts, valid = _seam_cloud(n, 3 * n + k, dup)
    idx, d2 = _sweep_model(pts, valid, k)
    ref = sweep.fused_sweep(t(pts), t(valid), k)
    np.testing.assert_array_equal(idx, ref[0][0].numpy())
    np.testing.assert_array_equal(d2.view(np.uint32),
                                  ref[1][0].numpy().view(np.uint32))
