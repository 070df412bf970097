"""Neighbourhood queries over padded point sets (port of
deeppointmap_tpu/ops/neighbors.py).

Every query is batched: points (B, N, 3), validity (B, N), centers
(B, S, 3). `knn` launches the CUDA kernel K2 (csrc/knn.cu) for tensors on
the GPU and runs `knn_plain` for tensors on the CPU. Both are exact and
give the same distances bit for bit, because both evaluate
|c|^2 - 2 c.p + |p|^2 in one fixed order of single-rounded operations.

Semantics kept from the JAX package: invalid points sit at distance 1e9;
neighbours ascend by distance, ties by index; when fewer than k points
are valid, the tail carries the 1e9 sentinel (and in-range indices).
"""

from __future__ import annotations

import numpy as np
import torch

from deeppointmap_tpu_torch import kernels

#: distance of invalid points (== deeppointmap_tpu.ops.neighbors._BIG)
BIG = 1e9
#: K2 keeps a center's k best as a sorted run in shared memory, of at most
#: this length (the JAX package's Pallas route takes k <= 512 too)
KNN_MAX_K = 512
#: from this k on K2 selects by radix select (its wide route), below it by
#: queue and merge; csrc/knn.cu's kWideK, mirrored here for reporting
KNN_WIDE_K = 42
#: `route` values of csrc/knn.cu's dpm_knn
_ROUTES = {"auto": 0, "narrow": 1, "wide": 2}
_IDX_BITS = 31


def f32(x: float) -> float:
    """`x` rounded to float32, as JAX rounds a Python scalar against an f32
    array; comparing a float32 tensor with it is then unambiguous."""
    return float(np.float32(x))


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...,) as ((x*x + y*y) + z*z)."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]


def pairwise_dist2(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., S, N) = |s|^2 - 2 s.d + |d|^2 (reference:
    network/encoder/utils.py:288-295). The cross term is summed
    elementwise in a fixed order, not by a matrix product, so K2 can
    reproduce it exactly."""
    s = src[..., :, None, :]
    d = dst[..., None, :, :]
    cross = (s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1]) \
        + s[..., 2] * d[..., 2]
    return sq_norm(src)[..., :, None] - 2.0 * cross \
        + sq_norm(dst)[..., None, :]


def in_radius_pairs(points, valid, centers, radius: float) -> int:
    """The number of (center, valid point) pairs within `radius`, by the
    membership rule K2, K3 and K4 share (pairwise_dist2 <= f32(r^2)): the
    work of the radius moments (utils/roofline.moments_cost). points
    (B, N, 3), valid (B, N), centers (B, S, 3). Plain PyTorch on either
    device, 2048 centers at a time; no kernel launch."""
    r2 = f32(radius * radius)
    count = 0
    for c0 in range(0, centers.shape[1], 2048):
        d = pairwise_dist2(centers[:, c0:c0 + 2048].float(),
                           points.float())
        count += int(((d <= r2) & valid[:, None, :]).sum())
    return count


def _p_feats(points: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> moment features [1 | p | xx xy xz yy yz zz] (B, N, 10)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                        y * y, y * z, z * z], dim=-1)


def moments_chunk(valid, d2, r2: float, feats64) -> torch.Tensor:
    """(B, C, 10) float32 radius moments [cnt | s(3) | S6(6)] of the centers
    whose distances to the points are d2 (B, C, N), over the valid points
    with d2 <= r2; cnt clamped to >= 1. `feats64` is `_p_feats` of the
    points in float64: the products are exact, the sums one float64 matrix
    product, rounded to float32 once. The plain moments of K2, K3 and K4."""
    w = (d2 <= r2) & valid[:, None, :]
    m = (w.double() @ feats64).float()
    m[..., 0].clamp_(min=1.0)
    return m


def knn_plain(points, centers, k: int, points_valid, radius: float = 0.0,
              center_chunk: int = 2048):
    """Plain version of K2; same arguments and returns as `knn`.

    Chunked over centers to bound the live (chunk, N) distance tile. The
    top-k runs on int64 keys (order-preserving distance bits, then the
    index), so ties go to the lower index exactly as in the kernel."""
    s = centers.shape[1]
    r2 = f32(radius * radius)
    feats64 = _p_feats(points.double()) if radius > 0 else None
    outs, moms = [], []
    for c0 in range(0, s, center_chunk):
        c = centers[:, c0:c0 + center_chunk]
        d = pairwise_dist2(c, points)
        if radius > 0:
            moms.append(moments_chunk(points_valid, d, r2, feats64))
        d = torch.where(points_valid[:, None, :], d, torch.full_like(d, BIG))
        bits = d.view(torch.int32)
        mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
        col = torch.arange(d.shape[-1], device=d.device)
        key = torch.topk((mono << _IDX_BITS) + col, k, dim=-1,
                         largest=False, sorted=True).values
        idx = key & ((1 << _IDX_BITS) - 1)
        outs.append((idx, torch.gather(d, -1, idx)))
    idx, dist2 = (torch.cat(parts, dim=1) for parts in zip(*outs))
    if radius <= 0:
        return idx, dist2
    m = torch.cat(moms, dim=1)
    return idx, dist2, m[..., 0], m[..., 1:4], m[..., 4:10]


def knn_shape(b: int, n: int, s: int, k: int, radius: float) -> tuple:
    """Key under which K2's launches are counted by shape."""
    return b, n, s, k, radius


def knn_route(k: int) -> str:
    """The route K2 takes at `k`: "wide" (radix select) from KNN_WIDE_K
    on, else "narrow" (queue and merge)."""
    return "wide" if k >= KNN_WIDE_K else "narrow"


def knn_cuda(points, centers, k: int, points_valid, radius: float = 0.0):
    """Launch K2 (csrc/knn.cu) on the current stream; same arguments and
    returns as `knn`. Tensors must be contiguous on one GPU.

    Replaces the TPU kernel deeppointmap_tpu/ops/pallas_knn.py
    (fused_knn_moments), exact where that one keeps one winner per index
    class. Bound: operations (8 FLOPs per center-point pair, ~20 more per
    in-radius pair); what costs is the selection. Below KNN_WIDE_K a warp
    shares four centers' thresholds, lanes queue the few candidates that
    beat them and the warp merges a full queue into the center's sorted run
    of 64-bit (distance, index) keys; from KNN_WIDE_K on a block takes a
    center, bounds its k-th key by a sample, keeps the keys under the bound
    in shared memory, radix-selects the k smallest among them and sorts
    them in one warp. The radius moments ride the distance pass as float64
    sums (csrc/knn.cu says more)."""
    return knn_cuda_route(points, centers, k, points_valid, radius, "auto")


def knn_cuda_route(points, centers, k: int, points_valid, radius: float,
                   route: str):
    """`knn_cuda` on the route `knn_route(k)` gives ("auto"), or on the
    "narrow" or the "wide" one at any k, to time one against the other."""
    b, n, c = points.shape
    if c != 3 or centers.dim() != 3 or centers.shape[0] != b \
            or centers.shape[2] != 3:
        raise ValueError("knn_cuda takes points (B, N, 3) and centers "
                         "(B, S, 3)")
    if points.dtype != torch.float32 or centers.dtype != torch.float32 \
            or points_valid.dtype != torch.bool:
        raise ValueError("knn_cuda takes float32 coordinates and bool "
                         "validity")
    if points_valid.shape != (b, n):
        raise ValueError("points_valid must be (B, N)")
    dev = points.device
    if centers.device != dev or points_valid.device != dev:
        raise ValueError("knn_cuda takes tensors on one device")
    if not (points.is_contiguous() and centers.is_contiguous()
            and points_valid.is_contiguous()):
        raise ValueError("knn_cuda takes contiguous tensors")
    if not 1 <= k <= min(n, KNN_MAX_K):
        raise ValueError(f"knn_cuda needs 1 <= k <= min(N, {KNN_MAX_K}) "
                         f"(got k={k}, N={n})")
    s = centers.shape[1]
    idx = torch.empty((b, s, k), dtype=torch.int64, device=dev)
    d2 = torch.empty((b, s, k), dtype=torch.float32, device=dev)
    mom = torch.empty((b, s, 10), dtype=torch.float32, device=dev) \
        if radius > 0 else None
    packed = torch.empty((b, n, 4), dtype=torch.float32, device=dev)
    kernels.KNN.launch(points.data_ptr(), points_valid.data_ptr(),
                       centers.data_ptr(), b, n, s, k, f32(radius * radius),
                       packed.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                       None if mom is None else mom.data_ptr(),
                       _ROUTES[route], kernels.stream_ptr(dev), device=dev,
                       shape=knn_shape(b, n, s, k, radius))
    if mom is None:
        return idx, d2
    return idx, d2, mom[..., 0], mom[..., 1:4], mom[..., 4:10]


def knn(points, centers, k: int, points_valid, radius: float = 0.0):
    """K nearest valid points for each center, with optional radius
    moments over the same pass.

    points (B, N, 3), centers (B, S, 3), points_valid (B, N) ->
    idx (B, S, k) int64 ascending by distance, dist2 (B, S, k) f32; with
    radius > 0 also cnt (B, S) (clamped to >= 1), s (B, S, 3) and
    S6 (B, S, 6) [xx xy xz yy yz zz] summed over the valid points within
    `radius` (ops/normals.filter_sweep's moments).

    GPU tensors go to K2 (or raise); CPU tensors take the plain version."""
    points = points.float().contiguous()
    centers = centers.float().contiguous()
    points_valid = points_valid.contiguous()
    if points.is_cuda:
        return knn_cuda(points, centers, k, points_valid, radius)
    return knn_plain(points, centers, k, points_valid, radius)


def hybrid_query(points, centers, k: int, radius: float, points_valid):
    """kNN then clamp-to-radius (reference 'hybrid-t3d' querier, network/
    encoder/utils.py:113-123): neighbours beyond `radius` become the
    nearest neighbour. Returns idx (B, S, k) int64."""
    idx, dist2 = knn(points, centers, k, points_valid)
    return torch.where(dist2 > f32(radius * radius), idx[..., :1], idx)


def ball_query(points, centers, k: int, radius: float, points_valid,
               center_chunk: int = 2048):
    """First-k-within-radius grouping (reference python fallback: network/
    encoder/utils.py:57-73): a center's neighbours are the k lowest-INDEX
    valid points inside its ball; slots beyond them repeat the first one
    (index 0 when the ball is empty). points (B, N, 3), centers (B, S, 3),
    points_valid (B, N) -> idx (B, S, k) int64. Plain PyTorch on either
    device, as the JAX package leaves it to XLA; chunked over centers."""
    n = points.shape[1]
    r2 = f32(radius * radius)
    col = torch.arange(n, device=points.device, dtype=torch.float32)
    outs = []
    for c0 in range(0, centers.shape[1], center_chunk):
        d = pairwise_dist2(centers[:, c0:c0 + center_chunk].float(),
                           points.float())
        in_ball = (d <= r2) & points_valid[:, None, :]
        # in-ball points rank above all others, each group by index
        score = torch.where(in_ball, -col, -2.0 * n - col)
        idx = torch.topk(score, k, dim=-1).indices
        picked = torch.gather(in_ball, -1, idx)
        outs.append(torch.where(picked, idx, idx[..., :1]))
    return torch.cat(outs, dim=1)


def group_points(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per batch: values (B, N, C), idx (B, ...) -> (B, ..., C)
    (reference: network/encoder/utils.py:346-355)."""
    b = values.shape[0]
    batch = torch.arange(b, device=values.device).view(
        b, *([1] * (idx.dim() - 1)))
    return values[batch, idx]
