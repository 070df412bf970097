"""Radius moments over all points (K3) and the fused preprocessing sweep
(K4): wrappers and plain versions (port of deeppointmap_tpu/ops/
pallas_moments.py and pallas_sweep.py).

Both are batched: points (B, N, 3) float32 and validity (B, N), every point
being a center. Tensors on the GPU launch the CUDA kernels (csrc/moments.cu,
csrc/sweep.cu) or raise; tensors on the CPU take the plain versions, which
only they and the tests use. Distances are `ops/neighbors.pairwise_dist2`,
the single-rounded float32 formula K2 uses, so K2, K3 and K4 agree bit for
bit on who lies inside a radius. The moments are summed in float64 with
exact products and rounded to float32 once.
"""

from __future__ import annotations

import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.ops.neighbors import (BIG, _IDX_BITS, _p_feats,
                                                  f32, moments_chunk,
                                                  pairwise_dist2)

#: K4 keeps the best two candidates of each index-mod-128 class
SWEEP_CLASSES = 128
#: the neighbour count K4 can return (the TPU kernel's limit)
SWEEP_MAX_K = SWEEP_CLASSES


def _check_scan(name: str, points, valid) -> None:
    if points.dim() != 3 or points.shape[2] != 3 \
            or valid.shape != points.shape[:2]:
        raise ValueError(f"{name} takes points (B, N, 3) and validity (B, N)")
    if points.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"{name} takes float32 points and bool validity")
    if valid.device != points.device:
        raise ValueError(f"{name} takes tensors on one device")
    if not (points.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def _split(mom: torch.Tensor):
    return mom[..., 0], mom[..., 1:4], mom[..., 4:10]


def _class_scratch(b: int, n: int, device) -> torch.Tensor:
    """Scratch for K3's and K4's class-major copy of the scan
    (csrc/radius.cuh `class_scratch_bytes`, which the kernels check): per
    index-mod-128 class, m4 slots of a float4 point and an int32 index (m4 =
    the class's member count rounded up to 4), its valid count and its two
    lowest invalid indices."""
    m = max(2, -(-n // SWEEP_CLASSES))
    m4 = -(-m // 4) * 4
    return torch.empty(b * SWEEP_CLASSES * (m4 * 20 + 12), dtype=torch.uint8,
                       device=device)


# ----------------------------------------------------------------- K3
def radius_moments_plain(points, valid, radius: float,
                         center_chunk: int = 1024):
    """Plain version of K3; same arguments and returns as
    `radius_moments`. Chunked over centers; each chunk's moments are one
    float64 matrix product of the membership mask with the features."""
    r2 = f32(radius * radius)
    feats64 = _p_feats(points.double())
    out = [moments_chunk(valid,
                         pairwise_dist2(points[:, c0:c0 + center_chunk],
                                        points), r2, feats64)
           for c0 in range(0, points.shape[1], center_chunk)]
    return _split(torch.cat(out, dim=1))


def moments_shape(b: int, n: int, radius: float) -> tuple:
    """Key under which K3's launches are counted by shape."""
    return b, n, radius


def radius_moments_cuda(points, valid, radius: float):
    """Launch K3 (csrc/moments.cu) on the current stream; same arguments
    and returns as `radius_moments`.

    Replaces the TPU kernel deeppointmap_tpu/ops/pallas_moments.py
    (radius_moments_pallas). Bound: operations (8 FLOPs per pair of a point
    with a valid point, ~20 per in-radius pair). The design packs the valid
    points once, class-major and compacted (invalid points cost nothing),
    and gives a block of 16 warps 64 centers, two a lane in registers, each
    warp walking 8 of the 128 classes: one broadcast load serves 64 centers;
    the float64 sums run only for points some lane has inside its radius
    and are added across warps in a fixed order (csrc/moments.cu says
    more)."""
    _check_scan("radius_moments_cuda", points, valid)
    b, n, _ = points.shape
    mom = torch.empty((b, n, 10), dtype=torch.float32, device=points.device)
    scratch = _class_scratch(b, n, points.device)
    kernels.MOMENTS.launch(points.data_ptr(), valid.data_ptr(), b, n,
                           f32(radius * radius), scratch.data_ptr(),
                           scratch.numel(), mom.data_ptr(),
                           kernels.stream_ptr(points.device),
                           shape=moments_shape(b, n, radius))
    return _split(mom)


def radius_moments(points, valid, radius: float):
    """Radius-PCA moments over ALL valid points within `radius` of every
    point, self included: points (B, N, 3), valid (B, N) -> cnt (B, N)
    clamped to >= 1, s (B, N, 3), S6 (B, N, 6) [xx xy xz yy yz zz].

    GPU tensors go to K3 (or raise); CPU tensors take the plain version."""
    if radius <= 0:
        raise ValueError(f"radius_moments needs radius > 0 (got {radius})")
    points = points.float().contiguous()
    valid = valid.contiguous()
    if points.is_cuda:
        return radius_moments_cuda(points, valid, radius)
    return radius_moments_plain(points, valid, radius)


# ----------------------------------------------------------------- K4
def fused_sweep_plain(points, valid, k: int, radius: float = 0.0,
                      center_chunk: int = 256):
    """Plain version of K4; same arguments and returns as `fused_sweep`.

    Every (center, point) pair becomes an int64 key (order-preserving
    distance bits, then the index; invalid points and the padding up to a
    multiple of 128 stand at 1e9). The two smallest keys of each
    index-mod-128 class are the candidates, and the k smallest of those 256
    the neighbours; an index from the padding is clamped to n - 1."""
    if not 1 <= k <= SWEEP_MAX_K:
        raise ValueError(f"fused_sweep needs 1 <= k <= {SWEEP_MAX_K} "
                         f"(got k={k})")
    b, n, _ = points.shape
    n_pad = max(2 * SWEEP_CLASSES, -(-n // SWEEP_CLASSES) * SWEEP_CLASSES)
    r2 = f32(radius * radius)
    feats64 = _p_feats(points.double()) if radius > 0 else None
    col = torch.arange(n_pad, device=points.device)
    low = (1 << _IDX_BITS) - 1
    idxs, d2s, moms = [], [], []
    for c0 in range(0, n, center_chunk):
        d = pairwise_dist2(points[:, c0:c0 + center_chunk], points)
        if radius > 0:
            moms.append(moments_chunk(valid, d, r2, feats64))
        d = torch.where(valid[:, None, :], d, torch.full_like(d, BIG))
        d = torch.nn.functional.pad(d, (0, n_pad - n), value=BIG)
        bits = d.view(torch.int32)
        mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
        key = ((mono << _IDX_BITS) + col).view(b, -1, n_pad // SWEEP_CLASSES,
                                               SWEEP_CLASSES)
        cand = torch.topk(key, 2, dim=2, largest=False).values
        key = torch.topk(cand.flatten(2), k, dim=-1, largest=False,
                         sorted=True).values
        mono = (key >> _IDX_BITS).to(torch.int32)
        idxs.append(torch.clamp(key & low, max=n - 1))
        d2s.append(torch.where(mono >= 0, mono,
                               mono ^ 0x7FFFFFFF).view(torch.float32))
    out = (torch.cat(idxs, dim=1), torch.cat(d2s, dim=1))
    if radius > 0:
        out += _split(torch.cat(moms, dim=1))
    return out


def sweep_shape(b: int, n: int, k: int, radius: float) -> tuple:
    """Key under which K4's launches are counted by shape."""
    return b, n, k, radius


def fused_sweep_cuda(points, valid, k: int, radius: float = 0.0):
    """Launch K4 (csrc/sweep.cu) on the current stream; same arguments and
    returns as `fused_sweep`.

    Replaces the TPU kernel deeppointmap_tpu/ops/pallas_sweep.py
    (fused_sweep_pallas), including the top-k over the 256 candidates that
    the TPU version leaves to XLA. Bound: operations (8 FLOPs per pair of a
    point with a valid point). The design packs each class's valid points
    once, compacted in index order, beside its two lowest invalid indices
    (invalid points are never visited; they enter as keys at 1e9 at the
    class end); a block of 16 warps owns 64 centers, two a lane, and warp w
    walks classes 8w .. 8w + 7 keeping each center's best two in registers,
    so the warps never merge; then 8 lanes select for each center: each
    lane sorts its 16 classes' 32 candidates by a fixed network, and k
    rounds of a shuffle butterfly over the 8 lanes' heads give the
    neighbours in order (csrc/sweep.cu says more)."""
    _check_scan("fused_sweep_cuda", points, valid)
    if not 1 <= k <= SWEEP_MAX_K:
        raise ValueError(f"fused_sweep_cuda needs 1 <= k <= {SWEEP_MAX_K} "
                         f"(got k={k})")
    b, n, _ = points.shape
    dev = points.device
    idx = torch.empty((b, n, k), dtype=torch.int64, device=dev)
    d2 = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    mom = torch.empty((b, n, 10), dtype=torch.float32, device=dev) \
        if radius > 0 else None
    scratch = _class_scratch(b, n, dev)
    kernels.SWEEP.launch(points.data_ptr(), valid.data_ptr(), b, n, k,
                         f32(radius * radius), scratch.data_ptr(),
                         scratch.numel(), idx.data_ptr(), d2.data_ptr(),
                         None if mom is None else mom.data_ptr(),
                         kernels.stream_ptr(dev),
                         shape=sweep_shape(b, n, k, radius))
    if mom is None:
        return idx, d2
    return (idx, d2) + _split(mom)


def fused_sweep(points, valid, k: int, radius: float = 0.0):
    """One distance pass over a scan: for every point its k nearest
    candidates and, with radius > 0, its radius moments.

    points (B, N, 3), valid (B, N) -> idx (B, N, k) int64 ascending by
    (distance, index), dist2 (B, N, k) f32 [, cnt (B, N), s (B, N, 3),
    S6 (B, N, 6) as `radius_moments`]. The neighbours are the k nearest
    among the best two valid points of each index-mod-128 class: exact
    unless three of a point's k nearest share a class (recall >= 0.97 at
    k = 17 and 41 on LiDAR scans). Invalid points stand at 1e9; with fewer
    than k valid candidates the tail carries 1e9 and an in-range index.

    GPU tensors go to K4 (or raise); CPU tensors take the plain version."""
    points = points.float().contiguous()
    valid = valid.contiguous()
    if points.is_cuda:
        return fused_sweep_cuda(points, valid, k, radius)
    return fused_sweep_plain(points, valid, k, radius)
