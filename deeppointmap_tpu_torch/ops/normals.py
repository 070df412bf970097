"""Surface normals from radius moments (port of
deeppointmap_tpu/ops/normals.py).

`filter_sweep` gives the preprocessing filters their top-k neighbour graph
and the radius-PCA moments. By default that is one K2 call
(ops/neighbors.knn with a radius): both come out of one exact pass over the
(P, P) distances. Two switches, off by default as in the JAX package, route
it through the other two kernels (ops/sweep.py): `USE_FUSED_SWEEP` takes the
graph and the moments from K4 (approximate neighbours, float64 moments), and
`USE_FUSED_MOMENTS` takes the moments from K3 (float64) beside K2's exact
graph. The smallest eigenvector comes from the closed-form eigenvalues of a
symmetric 3x3 matrix (Eberly / Smith).
"""

from __future__ import annotations

import math

import torch

from deeppointmap_tpu_torch.ops.neighbors import knn
from deeppointmap_tpu_torch.ops.sweep import (SWEEP_MAX_K, fused_sweep,
                                              radius_moments)

#: Moments from K3 (csrc/moments.cu), summed in float64 over all points in
#: the radius, instead of K2's float32 sums; the graph then comes from a
#: K2 pass without moments. The accuracy option of the JAX package
#: (USE_PALLAS_MOMENTS there).
USE_FUSED_MOMENTS = False
#: Graph and moments from K4 (csrc/sweep.cu) in one pass: neighbours are
#: approximate (best two per index-mod-128 class), moments as K3's. Takes
#: precedence over USE_FUSED_MOMENTS (USE_PALLAS_SWEEP in the JAX package).
USE_FUSED_SWEEP = False


def kernel_key() -> tuple:
    """The switches above as they stand: the part of a program's key
    (utils/graphs.py) that this module decides."""
    return USE_FUSED_MOMENTS, USE_FUSED_SWEEP


#: +z per (device, dtype): built once (a copy from the host, which syncs),
#: so that no call inside a CUDA graph capture copies from the host
_UP: dict = {}


def _up(dtype, device) -> torch.Tensor:
    key = (torch.device(device), dtype)
    up = _UP.get(key)
    if up is None:
        up = _UP.setdefault(key, torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                              device=device))
    return up


def dot3(a, b):
    """((a0 b0 + a1 b1) + a2 b2) over the last axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def smallest_eigvec_3x3(C: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue for symmetric
    (..., 3, 3) matrices, as float32; isotropic neighbourhoods fall back to
    +z. Closed-form eigenvalues (Eberly / Smith) and the most stable cross
    product of two rows of C - eig3 I, as in the JAX package.

    Computed in float64 and rounded once: PyTorch's float32 sqrt and
    division on the GPU are not correctly rounded, and a normal that
    differs in its last bit between the CPU and the GPU can flip a
    low-pass survivor, and with it every later FPS pick."""
    C = C.double()
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    q = C.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    A = C - q[..., None, None] * eye
    p2 = (A * A).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-20))
    b = A / p[..., None, None]
    det = b[..., 0, 0] * b[..., 1, 1] * b[..., 2, 2] \
        + b[..., 0, 1] * b[..., 1, 2] * b[..., 2, 0] \
        + b[..., 0, 2] * b[..., 1, 0] * b[..., 2, 1] \
        - b[..., 0, 2] * b[..., 1, 1] * b[..., 2, 0] \
        - b[..., 0, 0] * b[..., 1, 2] * b[..., 2, 1] \
        - b[..., 0, 1] * b[..., 1, 0] * b[..., 2, 2]
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    eig3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    M = C - eig3[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    crosses = torch.stack([torch.linalg.cross(r0, r1),
                           torch.linalg.cross(r0, r2),
                           torch.linalg.cross(r1, r2)], dim=-2)
    best = (crosses * crosses).sum(-1).argmax(dim=-1)   # the most stable
    v = torch.gather(crosses, -2,
                     best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    v = v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-20))
    up = _up(C.dtype, C.device)
    return torch.where((p2 < 1e-12)[..., None], up.expand_as(v), v).float()


def normals_from_moments(c, cnt, s, S6) -> torch.Tensor:
    """Smallest-eigenvector normals from radius moments, the covariance
    recovered centred at each center c,

        sum_w (p - c)(p - c)^T = S6 - s c^T - c s^T + cnt * c c^T,

    so the large E[pp^T] terms at +-60 m cancel analytically (here in
    float64). c (..., 3), cnt (...), s (..., 3), S6 (..., 6) -> (..., 3).

    A neighbourhood of one or two points has a covariance of rank 0 or 1
    and no defined normal: it gets +z. (The JAX package gives +z to the
    first and rounding noise to the second; its own jit and eager paths
    disagree there.)"""
    c, cnt, s, S6 = (x.double() for x in (c, cnt, s, S6))
    xx, xy, xz, yy, yz, zz = S6.unbind(-1)
    Sm = torch.stack([torch.stack([xx, xy, xz], -1),
                      torch.stack([xy, yy, yz], -1),
                      torch.stack([xz, yz, zz], -1)], -2)
    cen = Sm - s[..., :, None] * c[..., None, :] \
        - c[..., :, None] * s[..., None, :] \
        + cnt[..., None, None] * (c[..., :, None] * c[..., None, :])
    mu_c = s / cnt[..., None] - c
    cov = cen / cnt[..., None, None] - mu_c[..., :, None] * mu_c[..., None, :]
    n = smallest_eigvec_3x3(cov)
    up = _up(n.dtype, n.device)
    return torch.where((cnt <= 2)[..., None], up.expand_as(n), n)


def filter_sweep(pts, valid, k: int, radius: float):
    """ONE (P, P) sweep for the preprocessing filters: the top-k
    neighbour graph and, with radius > 0, the radius-PCA moments.
    pts (B, P, 3), valid (B, P) -> (idx, dist2[, cnt, s, S6]); k = 0 skips
    the graph (-> (cnt, s, S6)), radius <= 0 the moments.

    Routing: K4 when USE_FUSED_SWEEP is set and k fits it; K3 for the
    moments (and K2 without moments for the graph) when USE_FUSED_MOMENTS is
    set or no graph is asked for; else K2 with its fused moments."""
    if k <= 0 and radius <= 0:
        raise ValueError("filter_sweep with nothing to compute")
    pts = pts.float()
    if k > 0 and USE_FUSED_SWEEP and k <= SWEEP_MAX_K:
        return fused_sweep(pts, valid, k, max(radius, 0.0))
    if radius > 0 and (USE_FUSED_MOMENTS or k == 0):
        moments = radius_moments(pts, valid, radius)
        if k == 0:
            return moments
        return knn(pts, pts, k, valid) + moments
    return knn(pts, pts, k, valid, radius)


def radius_normals(xyz, valid, radius: float) -> torch.Tensor:
    """Unit normals (B, N, 3) by PCA over ALL valid points within `radius`
    of each point (the reference's Open3D radius search without a
    neighbour cap, dataloader/transforms.py:271), from K3's moments.
    Neighbourhoods of fewer than three points get +z; every point is a
    center, valid or not (callers mask the invalid ones)."""
    if radius <= 0:
        raise ValueError(f"radius_normals needs radius > 0 (got {radius})")
    return normals_from_moments(xyz.float(),
                                *filter_sweep(xyz, valid, 0, radius))
