"""The redesigned K1 (FPS) and K2 (kNN + moments) on the CPU: their plain
versions against the JAX package at the widths the redesign opened, and
pure-Python models of the kernels' algorithms (csrc/fps.cu: partitioned
argmax over packed messages; csrc/knn.cu: threshold, queue and merge by
ranks, and the wide route's radix select, ordered compaction and bitonic
sort) held to the plain versions on inputs with ties, so that what the CUDA
sources do is rehearsed where no card is.
"""

import bisect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.ops import neighbors as jnb
from deeppointmap_tpu.ops import normals as jnorm
from deeppointmap_tpu_torch.ops import neighbors as tnb
from deeppointmap_tpu_torch.ops import sampling as tsamp
from deeppointmap_tpu_torch.ops import sweep as tsweep
from tests.test_torch_ops import _same_sets_but_ties, relerr, scan, t

torch.set_num_threads(2)


# ------------------------------------------------- plain versions vs JAX
@pytest.mark.parametrize("k", [65, 128, 256, 512])
def test_knn_plain_wide_k_matches_jax(k):
    """k above the old limit of 64: index sets equal except at exact ties,
    dist2 within rtol 1e-5 of the terms' scale (the two distance formulas
    differ in their last bits, as in test_torch_ops.test_knn_matches_jax)."""
    assert tnb.KNN_MAX_K >= 128
    pts, valid = scan(6)
    centers = pts[:300] + np.float32(0.05)
    j_idx, j_d2 = (np.asarray(x) for x in jnb.knn(
        jnp.asarray(pts), jnp.asarray(centers), k, jnp.asarray(valid)))
    t_idx, t_d2 = (x[0].numpy() for x in tnb.knn(
        t(pts)[None], t(centers)[None], k, t(valid)[None]))
    _same_sets_but_ties(t_idx, t_d2, j_idx, j_d2)
    terms = np.max(np.sum(pts.astype(np.float64) ** 2, -1))
    err = np.max(np.abs(np.sort(t_d2, 1).astype(np.float64)
                        - np.sort(j_d2, 1)))
    assert err / terms <= 1e-5


def test_knn_plain_moments_are_the_float64_moments():
    """K2's plain moments equal K3's plain moments bit for bit (one
    function), and the JAX filter_sweep's float32 sums to relerr <= 1e-4
    where the counts agree (sums in another order and precision)."""
    pts, valid = scan(9)
    p, v = t(pts)[None], t(valid)[None]
    k2 = tnb.knn_plain(p, p, 5, v, 0.5)[2:]
    k3 = tsweep.radius_moments_plain(p, v, 0.5)
    for a, b in zip(k2, k3):
        assert torch.equal(a, b)
    j_cnt, j_s, j_S6 = (np.asarray(x) for x in jnorm.filter_sweep(
        jnp.asarray(pts), jnp.asarray(valid), 0, 0.5, "exact"))
    cnt, s, S6 = (x[0].numpy() for x in k2)
    same = (cnt == j_cnt) & valid
    assert np.mean(cnt[valid] == j_cnt[valid]) >= 0.995
    assert relerr(s, j_s, same) <= 1e-4 and relerr(S6, j_S6, same) <= 1e-4


# ------------------------------------------------------ model of knn.cu
EMPTY = 0xff8000007fffffff
QUEUE = 64


def _keys(points, valid, centers):
    """(S, N) 64-bit keys (order-preserving distance bits, then the index)
    of the plain version's distances, as Python ints."""
    d = tnb.pairwise_dist2(centers, points)
    d = torch.where(valid[None, :], d, torch.full_like(d, tnb.BIG))
    u = d.numpy().view(np.uint32).astype(np.int64)
    mono = np.where(u >> 31 == 1, u ^ 0xffffffff, u | 0x80000000)
    return [[(int(m) << 32) | j for j, m in enumerate(row)] for row in mono]


def _merge_keys(run, cand, k):
    """csrc/knn.cu merge_keys: every key's place is its rank among the
    candidates plus the run keys below it; each of the first k places must
    be written, and written twice only with the same value."""
    dst = [None] * k

    def put(pos, key):
        if pos < k:
            assert dst[pos] in (None, key)
            dst[pos] = key

    for key in cand:
        if key != EMPTY:
            put(sum(c < key for c in cand) + bisect.bisect_left(run, key),
                key)
    for i, key in enumerate(run):
        put(i + sum(c < key for c in cand), key)
    assert None not in dst and dst == sorted(dst)
    return dst


def _select(keys, n, k, parts):
    """One center through the kernel's scan: `parts` warps take 32-point
    steps in turn, in the kernel's scattered order (u * stride mod steps),
    each with its own run, queue and stale threshold; then the other parts'
    runs are merged into part 0's, 64 keys at a time."""
    steps = (n + 31) // 32
    stride = int(steps * 0.6180339887) | 1
    while np.gcd(stride, steps) != 1:
        stride += 2
    visited, runs = [], []
    for part in range(parts):
        run, queue, thr = [EMPTY] * k, [], EMPTY
        for u in range(part, steps, parts):
            j0 = u * stride % steps * 32
            visited.append(j0)
            hits = [key for key in keys[j0:min(j0 + 32, n)] if key < thr]
            if k == 1 and hits:         # the run is the threshold itself
                run = [min(hits)]
                thr = run[0]
                continue
            queue += hits
            assert len(queue) <= QUEUE
            if len(queue) >= 32:
                run, queue = _merge_keys(run, queue, k), []
                thr = run[k - 1]
        runs.append(_merge_keys(run, queue, k) if queue else run)
    assert sorted(visited) == list(range(0, n, 32))
    out = runs[0]
    for other in runs[1:]:
        for off in range(0, k, QUEUE):
            out = _merge_keys(out, other[off:off + QUEUE], k)
    return out


@pytest.mark.parametrize("n,n_valid,k,parts", [
    (300, 300, 5, 1), (300, 200, 33, 2), (200, 200, 70, 8), (150, 20, 40, 4),
    (97, 97, 97, 2), (64, 64, 1, 1), (200, 120, 1, 4)])
def test_queue_and_merge_model_matches_knn_plain(n, n_valid, k, parts):
    """The selection of csrc/knn.cu, in Python, on points with duplicates
    (exact distance ties) and with fewer valid points than k: indices and
    distances equal to knn_plain, whatever the split."""
    g = np.random.default_rng(n + k)
    pts = g.normal(size=(n, 3)).astype(np.float32)
    pts[n // 2:] = pts[:n - n // 2]              # every point twice
    valid = np.zeros(n, bool)
    valid[g.permutation(n)[:n_valid]] = True
    centers = pts[g.permutation(n)[:6]]
    p, v, c = t(pts), t(valid), t(centers)
    ref_idx, ref_d2 = tnb.knn_plain(p[None], c[None], k, v[None])
    for row, keys in enumerate(_keys(p, v, c)):
        run = _select(keys, n, k, parts)
        assert [key & 0xffffffff for key in run] == ref_idx[0, row].tolist()
        bits = np.array([key >> 32 for key in run], np.uint32)
        bits = np.where(bits >> 31 == 1, bits ^ 0x80000000, ~bits)
        np.testing.assert_array_equal(bits.view(np.float32),
                                      ref_d2[0, row].numpy())


# ------------------------------------------ model of knn.cu's wide route
DIGIT = 8
ALL = (1 << 64) - 1


def _bitonic(a):
    """csrc/knn.cu's bitonic network over a power-of-two list, in place:
    at every (size, stride) stage pair t compares slots i and i + stride,
    i = 2t - t mod stride, ascending where i & size == 0."""
    kp2 = len(a)
    size = 2
    while size <= kp2:
        stride = size // 2
        while stride:
            for t in range(kp2 // 2):
                i = 2 * t - (t & (stride - 1))
                x, y = a[i], a[i + stride]
                if (x > y) == ((i & size) == 0):
                    a[i], a[i + stride] = y, x
            stride //= 2
        size *= 2


def _sample(n, k, cap):
    """csrc/knn.cu sample_size and golden_stride with a list of `cap` keys
    -> the sampled point indices."""
    if n <= cap:
        return []
    m = min(cap, max(k, -(-4 * k * n // cap)))
    stride = int(n * 0.6180339887) | 1
    while np.gcd(stride, n) != 1:
        stride += 2
    return [i * stride % n for i in range(m)]


def _select_bound(keys, k, room):
    """csrc/knn.cu select_bound: radix select on the 64-bit keys, DIGIT
    bits a pass from the top (the distance bits, then the index bits),
    until at most `room` keys lie at or below the selected bucket -> the
    bucket's largest key."""
    prefix, mask, kk = 0, 0, k
    for shift in range(64 - DIGIT, -1, -DIGIT):
        hist = [0] * (1 << DIGIT)
        for key in keys:
            if key & mask == prefix:
                hist[(key >> shift) & ((1 << DIGIT) - 1)] += 1
        below = 0
        for digit, c in enumerate(hist):      # exactly one bin holds it
            if below < kk <= below + c:
                break
            below += c
        kk -= below
        prefix |= digit << shift
        mask |= ((1 << DIGIT) - 1) << shift
        if k - kk + c <= room or shift == 0:
            bound = prefix | (ALL & ~mask)
            assert k <= sum(key <= bound for key in keys) <= room
            return bound


def _wide_select(keys, n, k, cap, rng):
    """One center through the wide route with a list of `cap` keys: the
    sample's bound (at least k, at most 2k of its keys at or below it)
    bounds the candidates (the sampled indices distinct),
    the candidates are appended in any order (shuffled here), the select
    leaves at most kp2 keys at or below its bound (the scan itself if the
    list overflowed), kEmpty pads them to kp2 (at least 32) and the network
    sorts.
    -> (first k keys, sample size, overflowed)"""
    kp2 = 32
    while kp2 < k:
        kp2 *= 2
    sample = _sample(n, k, cap)
    assert len(set(sample)) == len(sample) <= cap
    tau = ALL
    if sample:
        tau = _select_bound([keys[j] for j in sample], k, 2 * k)
    listed = [key for key in keys if key <= tau]
    rng.shuffle(listed)
    over = len(listed) > cap
    src = keys if over else listed
    bound = _select_bound(src, k, kp2)
    sel = [key for key in src if key <= bound]
    rng.shuffle(sel)
    sel += [EMPTY] * (kp2 - len(sel))
    _bitonic(sel)
    return sel[:k], len(sample), over


@pytest.mark.parametrize("n,n_valid,k,layout,cap,expect", [
    (300, 300, 70, "twice", 4096, "whole"),        # duplicated points
    (500, 40, 100, "twice", 4096, "whole"),        # fewer valid points than k
    (97, 97, 97, "twice", 4096, "whole"),          # k = N, N no multiple of 32
    (200, 200, 70, "same", 4096, "whole"),         # every distance tied
    (1000, 900, tnb.KNN_WIDE_K - 1, "twice", 512, "sample"),  # threshold
    (1000, 900, tnb.KNN_WIDE_K + 1, "twice", 512, "sample"),
    (2100, 2000, 300, "twice", 1024, "sample"),    # k = 300 of a sample
    (3000, 3000, 100, "same", 1024, "sample"),
    (2000, 2000, 100, "hidden", 512, "overflow"),  # the sample misleads
    (777, 700, 512, "random", 4096, "whole")])
def test_radix_select_model_matches_knn_plain(n, n_valid, k, layout, cap,
                                              expect):
    """The wide route of csrc/knn.cu, in Python, on points with exact
    distance ties (the index digits of the keys settle them), with fewer
    valid points than k (their tail at 1e9, the lowest invalid indices), at
    k = N, with a sampled bound and with a sample whose points lie far away
    (the list overflows; the scan itself is selected): indices and distances
    equal to knn_plain."""
    g = np.random.default_rng(n + k)
    pts = g.normal(size=(n, 3)).astype(np.float32)
    if layout == "twice":
        pts[n // 2:] = pts[:n - n // 2]
    elif layout == "same":
        pts[:] = pts[0]
    pool = np.arange(n)
    if layout == "hidden":          # the sampled points far from the centers
        pts[_sample(n, k, cap)] *= 100.0
        pool = np.setdiff1d(pool, _sample(n, k, cap))
    valid = np.zeros(n, bool)
    valid[g.permutation(n)[:n_valid]] = True
    centers = np.concatenate([pts[g.permutation(pool)[:4]],
                              g.normal(size=(2, 3)).astype(np.float32)])
    p, v, c = t(pts), t(valid), t(centers)
    ref_idx, ref_d2 = tnb.knn_plain(p[None], c[None], k, v[None])
    for row, keys in enumerate(_keys(p, v, c)):
        run, sampled, over = _wide_select(keys, n, k, cap, g)
        assert (sampled > 0, over) == {"whole": (False, False),
                                      "sample": (True, False),
                                      "overflow": (True, True)}[expect]
        assert [key & 0xffffffff for key in run] == ref_idx[0, row].tolist()
        bits = np.array([key >> 32 for key in run], np.uint32)
        bits = np.where(bits >> 31 == 1, bits ^ 0x80000000, ~bits)
        np.testing.assert_array_equal(bits.view(np.float32),
                                      ref_d2[0, row].numpy())


def test_wide_threshold_mirrors_the_source():
    """ops/neighbors.py's KNN_WIDE_K and KNN_MAX_K are csrc/knn.cu's kWideK
    and kMaxK; the threshold lies above every k a path asks for (41) and
    within the range the card's timings chose from (42..128)."""
    src = (Path(tnb.__file__).resolve().parent.parent / "csrc"
           / "knn.cu").read_text()
    assert int(re.search(r"constexpr int kWideK = (\d+);", src)[1]) \
        == tnb.KNN_WIDE_K
    assert int(re.search(r"constexpr int kMaxK = (\d+);", src)[1]) \
        == tnb.KNN_MAX_K
    assert 41 < tnb.KNN_WIDE_K <= 128
    assert [tnb.knn_route(k) for k in (1, 41, tnb.KNN_WIDE_K - 1,
                                       tnb.KNN_WIDE_K, 512)] \
        == ["narrow"] * 3 + ["wide"] * 2


# ------------------------------------------------------ model of fps.cu
IDX_BITS, NONE = 14, (1 << 14) - 1


def _fps_model(xyz, valid, k, threads, per, cluster):
    """One scan through csrc/fps.cu's layout: thread g of threads * cluster
    owns points g, g + G, ...; key = float bits + 1 of the min-distance, 0
    for picked and invalid points; a warp's winner is (max key, lowest
    index); the warps' winners travel as (key | tag | index) messages and
    every warp reduces all of them."""
    n, G = len(xyz), threads * cluster
    assert G * per >= n and n <= 1 << IDX_BITS
    md = np.where(valid, np.float32(3.4e38), np.float32(-1.0))
    out, last = [], None
    for step in range(k):
        if last is not None:
            dx, dy, dz = (xyz[:, a] - xyz[last, a] for a in range(3))
            md = np.minimum(md, (dx * dx + dy * dy) + dz * dz)
            md[last] = -1.0
        key = np.where(md < 0, 0, md.view(np.uint32).astype(np.int64) + 1)
        msgs = []
        for w0 in range(0, G, 32):                       # one warp
            best = []
            for g in range(w0, w0 + 32):                 # one thread
                bk, bi = 0, NONE
                for i, j in enumerate(range(g, n, G)):
                    if i == 0 or key[j] > bk:
                        bk, bi = int(key[j]), j
                best.append((bk, bi))
            mk = max(bk for bk, _ in best)
            mi = min(bi if bk == mk else NONE for bk, bi in best)
            msgs.append((mk << 32) | ((step + 1) << IDX_BITS) | mi)
        assert all((m >> IDX_BITS) & 0x3ffff == step + 1 for m in msgs)
        mk = max(m >> 32 for m in msgs)
        last = min(m & NONE if m >> 32 == mk else NONE for m in msgs)
        out.append(last)
    return out


@pytest.mark.parametrize("n,n_valid,k,threads,per,cluster", [
    (300, 300, 80, 32, 8, 2),       # n not a multiple of the partition
    (70, 70, 70, 64, 2, 1),         # every point picked
    (256, 40, 64, 32, 8, 1),        # one warp; fewer valid points than k
    (500, 350, 100, 32, 4, 4)])
def test_partitioned_argmax_model_matches_fps_plain(n, n_valid, k, threads,
                                                    per, cluster):
    """The argmax of csrc/fps.cu, in Python, on points with duplicates
    (min-distance ties, zero distances between a pick and its twin):
    indices equal to farthest_point_sampling_plain on every slot, the slots
    beyond the valid points included."""
    g = np.random.default_rng(n + k)
    xyz = g.normal(size=(n, 3)).astype(np.float32)
    xyz[n // 2:] = xyz[:n - n // 2]
    valid = np.zeros(n, bool)
    valid[g.permutation(n)[:n_valid]] = True
    valid[0] = False                            # the first pick is not 0
    ref = tsamp.farthest_point_sampling_plain(t(xyz)[None], t(valid)[None], k)
    assert _fps_model(xyz, valid, k, threads, per, cluster) == ref[0].tolist()
