"""Weighted Kabsch/SVD rigid registration with iterative inlier trimming
(port of deeppointmap_tpu/ops/kabsch.py, `weighted_kabsch`).

The reference's dynamic while loop (network/decoder/decoder.py:227-265)
runs a fixed 3 solves with a `stopped` flag held in a tensor, so the
solve never waits on the host. The covariance is formed after centring
and decomposed in float32; a determinant correction rules out
reflections.
"""

from __future__ import annotations

import torch

_MIN_INLIERS = 30
_TOPK_SEED = 64


def top_k(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest, descending, ties to
    the lower index (a stable sort, where torch.topk leaves ties open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _apply_rt(pts, R, t):
    return pts @ R.T + t[None, :]


def _solve_rt(src, dst, w):
    """One weighted Kabsch solve. src/dst (K, 3), w (K,) >= 0."""
    wsum = torch.clamp(w.sum(), min=1e-12)
    cs = (src * w[:, None]).sum(0) / wsum
    cd = (dst * w[:, None]).sum(0) / wsum
    S = ((src - cs) * w[:, None]).T @ (dst - cd)
    u, _, vt = torch.linalg.svd(S)
    v = vt.T
    det = torch.linalg.det(v @ u.T)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det])
    R = (v * d[None, :]) @ u.T
    t = cd - R @ cs
    return R, t


def weighted_kabsch(src, dst, weight, valid, num_iter: int = 3,
                    std_ratio: float = 3.0):
    """src/dst (K, 3), weight (K,) >= 0, valid (K,) bool ->
    (R (3, 3), t (3,), inlier mask (K,), rmse scalar).

    Trimming rule per solve (reference: decoder.py:247-256): residuals over
    all pairs; pairs with err <= mean + std_ratio * sigma of the current
    inliers' residuals stay. Stops when the mask is stable or fewer than
    30 inliers remain."""
    k = src.shape[0]
    src = src.float()
    dst = dst.float()
    w_masked = torch.where(valid, weight.float(), torch.zeros_like(weight))

    inlier = w_masked > 0.5
    top_idx = top_k(w_masked, min(_TOPK_SEED, k))[1]
    inlier[top_idx] = True
    inlier = inlier & valid

    stopped = torch.zeros((), dtype=torch.bool, device=src.device)
    R = torch.eye(3, dtype=torch.float32, device=src.device)
    t = torch.zeros(3, dtype=torch.float32, device=src.device)
    for _ in range(num_iter):
        R_new, t_new = _solve_rt(src, dst, w_masked * inlier)
        R = torch.where(stopped, R, R_new)
        t = torch.where(stopped, t, t_new)
        err = torch.linalg.norm(_apply_rt(src, R, t) - dst, dim=-1)
        inf = inlier.float()
        n_in = torch.clamp(inf.sum(), min=1.0)
        mean = (err * inf).sum() / n_in
        var = (((err - mean) ** 2) * inf).sum() / torch.clamp(n_in - 1.0,
                                                              min=1.0)
        new_inlier = (err <= mean + std_ratio * torch.sqrt(var)) & valid
        same = torch.all(new_inlier == inlier)
        too_few = new_inlier.sum() < _MIN_INLIERS
        inlier = torch.where(stopped, inlier, new_inlier)
        stopped = stopped | same | too_few

    err2 = ((_apply_rt(src, R, t) - dst) ** 2).sum(-1)
    inf = inlier.float()
    n_in = torch.clamp(inf.sum(), min=1.0)
    rmse = torch.sqrt((err2 * inf).sum() / n_in)
    return R, t, inlier, rmse
