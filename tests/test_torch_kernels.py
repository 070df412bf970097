"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them: `python -m pytest --noconftest tests/test_torch_kernels.py`.
"""

import numpy as np
import pytest
import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.ops import neighbors, sampling, sweep

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(b, n, n_valid, seed, scale=20.0):
    g = np.random.default_rng(seed)
    xyz = (g.normal(size=(b, n, 3)) * scale).astype(np.float32)
    valid = np.zeros((b, n), bool)
    for i in range(b):
        valid[i, g.permutation(n)[:n_valid]] = True
    return torch.from_numpy(xyz), torch.from_numpy(valid)


def _ulp_close(a, r):
    """Equal to within one float32 ulp of the reference."""
    a, r = a.double(), r.double()
    ulp = torch.ldexp(torch.ones_like(r),
                      torch.frexp(r.abs().clamp(min=1e-30))[1] - 24)
    assert bool(((a - r).abs() <= ulp).all()), float((a - r).abs().max())


@pytest.mark.parametrize("b,n,n_valid,k,twice", [
    (1, 16384, 9000, 4096, False), (4, 4096, 4096, 1024, False),
    (2, 1000, 700, 256, False), (1, 64, 20, 16, False),
    (3, 1500, 1500, 1500, False),
    (2, 16384, 16384, 2048, True),      # a cluster a scan, every point twice
    (1, 10001, 9000, 2500, False),      # the cluster's last blocks are short
    (3, 5000, 300, 1250, False),        # fewer valid points than k
    (2, 3000, 3000, 3000, True),        # one-block cluster, all points picked
    (4, 200, 150, 200, True)])          # one warp
def test_fps_bitwise(dev, b, n, n_valid, k, twice):
    """Indices identical to the plain version (single-rounded distances in
    the same order, argmax ties to the lowest index), whatever the layout:
    one warp, one block or a cluster of blocks."""
    xyz, valid = (x.to(dev) for x in _cloud(b, n, n_valid, n + k))
    if twice:
        xyz[:, n // 2:] = xyz[:, :n - n // 2]
    before = kernels.FPS.launches
    idx, sel = sampling.batched_fps(xyz, valid, k)
    assert kernels.FPS.launches == before + 1
    ref = sampling.farthest_point_sampling_plain(xyz, valid, k)
    torch.cuda.synchronize()
    sel_ref = torch.arange(k, device=dev)[None] < valid.sum(1)[:, None]
    torch.testing.assert_close(sel, sel_ref, rtol=0, atol=0)
    torch.testing.assert_close(idx[sel], ref[sel], rtol=0, atol=0)
    # beyond the valid points both repeat index 0
    torch.testing.assert_close(idx, ref, rtol=0, atol=0)


@pytest.mark.parametrize("n,s,k,radius,scale", [
    (16384, 16384, 17, 0.5, 20.0),      # preprocess sweep, raw meters
    (4096, 4096, 32, 0.0, 1 / 3.0),     # a level graph, normalized
    (16384, 4096, 1, 0.0, 20.0),        # infomat 1-NN
    (777, 301, 3, 0.0, 1.0),            # ragged, FP 3-NN
    (2500, 999, 7, 0.3, 1.0),           # generic list length
    (300, 130, 40, 0.0, 1.0),
    (50, 70, 16, 0.0, 1.0),
    (3000, 6000, 5, 0.0, 1.0),          # two warps per center group
    (5000, 9000, 32, 0.0, 1.0),         # one warp per center group
    (16384, 16384, 41, 0.5, 20.0),      # the sweep-reuse width, with moments
    (4096, 1024, 65, 0.0, 1.0),         # beyond the earlier limit of 64
    (4096, 1023, 128, 0.2, 1.0),
    (2000, 50, 512, 0.0, 1.0),          # the widest run
    (3000, 1001, 40, 0.3, -1.0),        # every point twice: exact ties
    (600, 77, 40, 0.5, 1.0),            # with 20 valid points: fewer than k
    # the wide route (k >= KNN_WIDE_K) and its threshold
    (4096, 1024, neighbors.KNN_WIDE_K - 1, 0.0, 1.0),
    (4096, 1024, neighbors.KNN_WIDE_K + 1, 0.0, 1.0),
    (4096, 1023, 256, 0.2, 1.0),
    (16384, 16384, 128, 0.0, 20.0),
    (20000, 300, 200, 0.5, 20.0),       # a sampled bound: N > the list
    (3000, 1001, 200, 0.3, -1.0),       # exact ties at the k-th key
    (600, 77, 100, 0.5, 1.0),           # 20 valid points
    (300, 45, 300, 0.0, 1.0)])          # k = N
def test_knn_bitwise(dev, n, s, k, radius, scale):
    """Indices and distances identical to the plain version (both evaluate
    one fixed order of single-rounded operations and rank 64-bit keys);
    cnt equal, s and S6 within one float32 ulp (float64 sums in another
    order, rounded once). The shapes cover each split of a center group's
    scan over 1, 2, 4 or 8 warps, and the wide route with its distances
    kept in shared memory or measured again."""
    twice, scale = scale < 0, abs(scale)
    n_valid = 20 if n == 600 else int(0.8 * n)
    pts, valid = (x.to(dev) for x in _cloud(1, n, n_valid, n + k, scale))
    if twice:
        pts[:, n // 2:] = pts[:, :n - n // 2]
    centers = pts[:, torch.randperm(n, device=dev)[:s]] if s <= n else None
    if centers is None:
        centers = _cloud(1, s, s, k, scale)[0].to(dev)
    got = neighbors.knn_cuda(pts, centers.contiguous(), k, valid, radius)
    ref = neighbors.knn_plain(pts, centers.contiguous(), k, valid, radius)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (5 if radius > 0 else 2)
    for a, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    for a, r in zip(got[3:], ref[3:]):
        _ulp_close(a, r)
    assert int(got[0].min()) >= 0 and int(got[0].max()) < n


@pytest.mark.parametrize("k", sorted({1, 41, neighbors.KNN_WIDE_K - 1,
                                      neighbors.KNN_WIDE_K, 128, 512}))
@pytest.mark.parametrize("radius", [0.0, 0.3])
def test_knn_routes_agree(dev, k, radius):
    """Both routes of K2, forced at any k, equal the plain version (and so
    each other) on points that all occur twice; `knn_cuda` takes the route
    `knn_route` names."""
    pts, valid = (x.to(dev) for x in _cloud(1, 2000, 1500, k))
    pts[:, 1000:] = pts[:, :1000]
    centers = pts[:, :333].contiguous()
    ref = neighbors.knn_plain(pts, centers, k, valid, radius)
    for route in ("narrow", "wide"):
        got = neighbors.knn_cuda_route(pts, centers, k, valid, radius, route)
        torch.cuda.synchronize()
        for a, r in zip(got[:3], ref[:3]):
            torch.testing.assert_close(a, r, rtol=0, atol=0)
        for a, r in zip(got[3:], ref[3:]):
            _ulp_close(a, r)
    assert neighbors.knn_route(k) == ("wide" if k >= neighbors.KNN_WIDE_K
                                      else "narrow")


def test_knn_wide_sample_that_misleads(dev):
    """The wide route when its sample's k-th key bounds too many candidates
    for the list: the sampled points (csrc/knn.cu sample_size and
    golden_stride: 4kn / 4096 of them, i * stride mod N) lie 100 times
    farther out than the rest, so the list overflows and the route selects
    over the scan itself. Identical to the plain version."""
    n, k = 8000, 100
    pts, valid = (x.to(dev) for x in _cloud(1, n, n, 3, scale=1.0))
    stride = int(n * 0.6180339887) | 1
    while np.gcd(stride, n) != 1:
        stride += 2
    m = min(4096, max(k, -(-4 * k * n // 4096)))
    sampled = torch.tensor([i * stride % n for i in range(m)], device=dev)
    pts[0, sampled] *= 100.0
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[sampled] = False
    centers = pts[:, keep][:, :500].contiguous()
    got = neighbors.knn_cuda(pts, centers, k, valid, 0.5)
    ref = neighbors.knn_plain(pts, centers, k, valid, 0.5)
    torch.cuda.synchronize()
    for a, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    for a, r in zip(got[3:], ref[3:]):
        _ulp_close(a, r)


def test_knn_tail_carries_sentinel(dev):
    pts, valid = (x.to(dev) for x in _cloud(1, 100, 5, 0))
    idx, d2 = neighbors.knn(pts, pts, 12, valid)
    torch.cuda.synchronize()
    assert bool((d2[..., 5:] == 1e9).all())
    assert int(idx.min()) >= 0 and int(idx.max()) < 100


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    pts, valid = (x.to(dev) for x in _cloud(1, 64, 64, 1))
    with pytest.raises(ValueError):
        neighbors.knn_cuda(pts.double(), pts, 4, valid)
    with pytest.raises(ValueError):
        neighbors.knn_cuda(pts, pts, 65, valid)          # k above N = 64
    big, big_v = (x.to(dev) for x in _cloud(1, 1000, 1000, 2))
    with pytest.raises(ValueError, match=str(neighbors.KNN_MAX_K)):
        neighbors.knn_cuda(big, big, neighbors.KNN_MAX_K + 1, big_v)
    with pytest.raises(ValueError):
        sampling.fps_cuda(pts.transpose(1, 2).contiguous().transpose(1, 2),
                          valid, 8)
    with pytest.raises(ValueError):
        sampling.fps_cuda(torch.zeros(1, 16385, 3, device=dev),
                          torch.ones(1, 16385, dtype=torch.bool, device=dev), 8)


def _seams(pts, valid, twice):
    """The seams of K3's and K4's class-major layout on a cloud: a whole
    invalid stretch in the middle (two 128-point tiles), classes 5 and 77
    with at most one valid point, and with `twice` every point twice
    (distance ties across classes)."""
    n = pts.shape[1]
    if twice:
        pts[:, n // 2:] = pts[:, :n - n // 2]
    valid[:, n // 3:n // 3 + 256] = False
    cls = torch.arange(n, device=valid.device) % 128
    valid[:, (cls == 5) | (cls == 77)] = False
    valid[:, 5] = True
    return pts, valid


@pytest.mark.parametrize("b,n,n_valid,radius,scale,seams", [
    (1, 16384, 10000, 0.5, 20.0, False),   # the preprocess shape, raw meters
    (2, 1000, 37, 2.0, 5.0, False),        # N not a multiple of 128, few valid
    (3, 130, 130, 1.0, 1.0, False),
    (1, 3, 2, 1.0, 1.0, False),
    (1, 16384, 9500, 0.5, 20.0, True),     # scattered, invalid tiles, ties
    (2, 5001, 3000, 1.5, 3.0, True),       # ragged, B = 2
    (1, 700, 500, 4.0, 2.0, True)])        # one block of centers, dense hits
def test_moments_match_plain(dev, b, n, n_valid, radius, scale, seams):
    """K3 against its plain version: cnt equal, s and S6 within one float32
    ulp (both sum exact float64 products and round once; only the order of
    the float64 additions differs), at the seams of its layout too."""
    pts, valid = (x.to(dev) for x in _cloud(b, n, n_valid, n, scale))
    if seams:
        pts, valid = _seams(pts, valid, True)
    before = kernels.MOMENTS.launches
    got = sweep.radius_moments(pts, valid, radius)
    assert kernels.MOMENTS.launches == before + 1
    ref = sweep.radius_moments_plain(pts, valid, radius)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    _ulp_close(got[1], ref[1])
    _ulp_close(got[2], ref[2])


@pytest.mark.parametrize("b,n,n_valid,k,radius,scale,seams", [
    (1, 16384, 10000, 41, 0.5, 20.0, False),   # sweep_reuse shape, raw meters
    (1, 16384, 10000, 17, 0.0, 20.0, False),
    (2, 1000, 37, 41, 2.0, 5.0, False),        # N not a multiple of 128
    (3, 130, 130, 128, 0.0, 1.0, False),       # fewer than two points a class
    (1, 5, 3, 7, 1.0, 1.0, False),             # k above N
    (1, 16384, 9500, 41, 0.5, 20.0, True),     # scattered, invalid tiles, ties
    (1, 16384, 9500, 17, 0.5, 20.0, True),
    (2, 5001, 3000, 1, 1.0, 3.0, True),        # ragged, B = 2
    (2, 5001, 3000, 128, 0.0, 3.0, True),
    (1, 700, 150, 41, 2.0, 2.0, True),         # fewer valid candidates than k
    (2, 300, 100, 128, 0.0, 1.0, True)])
def test_sweep_bitwise(dev, b, n, n_valid, k, radius, scale, seams):
    """K4 against its plain version: indices and distances identical (the
    same class rule on the same single-rounded distances), moments as K3's;
    indices stay in range. The seam cases cover every part of the layout:
    classes with fewer than two valid points, whole invalid tiles, ragged n,
    exact ties, fewer valid candidates than k, B = 2."""
    pts, valid = (x.to(dev) for x in _cloud(b, n, n_valid, n + k, scale))
    if seams:
        pts, valid = _seams(pts, valid, True)
    before = kernels.SWEEP.launches
    got = sweep.fused_sweep(pts, valid, k, radius)
    assert kernels.SWEEP.launches == before + 1
    ref = sweep.fused_sweep_plain(pts, valid, k, radius)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (5 if radius > 0 else 2)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    assert int(got[0].min()) >= 0 and int(got[0].max()) < n
    if radius > 0:
        torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)
        _ulp_close(got[3], ref[3])
        _ulp_close(got[4], ref[4])


def test_sweep_members_agree_with_knn(dev):
    """K2, K3 and K4 decide radius membership on the same bits: equal
    counts; K4's nearest neighbour is the exact one."""
    pts, valid = (x.to(dev) for x in _cloud(1, 4096, 3000, 5, 3.0))
    k2 = neighbors.knn(pts, pts, 8, valid, 0.7)
    k3 = sweep.radius_moments(pts, valid, 0.7)
    k4 = sweep.fused_sweep(pts, valid, 8, 0.7)
    torch.cuda.synchronize()
    torch.testing.assert_close(k2[2], k3[0], rtol=0, atol=0)
    torch.testing.assert_close(k4[2], k3[0], rtol=0, atol=0)
    torch.testing.assert_close(k4[0][..., :2], k2[0][..., :2], rtol=0, atol=0)


def test_sweep_wrappers_refuse_what_the_kernels_do_not_take(dev):
    pts, valid = (x.to(dev) for x in _cloud(1, 64, 64, 1))
    with pytest.raises(ValueError):
        sweep.fused_sweep_cuda(pts, valid, 129)
    with pytest.raises(ValueError):
        sweep.fused_sweep_cuda(pts.double(), valid, 4)
    with pytest.raises(ValueError):
        sweep.radius_moments_cuda(pts, valid[:, :32], 1.0)
    with pytest.raises(ValueError):
        sweep.radius_moments(pts, valid, 0.0)
