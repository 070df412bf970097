"""6x6 information matrix for pose-graph edges (port of
deeppointmap_tpu/ops/infomat.py).

Transform the source cloud by the estimated SE3, find each moved point's
nearest target point (K2 with k=1 on the GPU), keep matches within
`radius`, and accumulate G^T G over the matched target points
(reference: system/modules/utils.py:60-113).
"""

from __future__ import annotations

import torch

from deeppointmap_tpu_torch.ops.neighbors import f32, knn


def _gtg(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """G^T G over matched target points t (K, 3), mask (K,) bool. Per
    point the Jacobian rows are [0, z, -y, 1, 0, 0], [-z, 0, x, 0, 1, 0],
    [y, -x, 0, 0, 0, 1] (reference: system/modules/utils.py:88-103)."""
    x, y, z = t.unbind(-1)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    g1 = torch.stack([zero, z, -y, one, zero, zero], dim=1)
    g2 = torch.stack([-z, zero, x, zero, one, zero], dim=1)
    g3 = torch.stack([y, -x, zero, zero, zero, one], dim=1)
    G = torch.cat([g1, g2, g3], dim=0) * mask.float().repeat(3)[:, None]
    return G.T @ G


def information_matrix(src, src_valid, dst, dst_valid, R, t,
                       radius: float = 1.0, stride: int = 1):
    """src (N, 3), src_valid (N,), dst (M, 3), dst_valid (M,), R (3, 3),
    t (3,) -> the 6x6 information matrix (float32).

    stride > 1 estimates G^T G from every stride-th source point, rescaled
    by `stride` (unbiased); stride = 1 is the reference's full sum."""
    if stride > 1:
        src = src[::stride]
        src_valid = src_valid[::stride]
    moved = src.float() @ R.T + t.reshape(1, 3)
    idx, dist2 = knn(dst[None], moved[None], 1, dst_valid[None])
    idx, dist2 = idx[0, :, 0], dist2[0, :, 0]
    mask = (dist2 <= f32(radius * radius)) & src_valid
    out = _gtg(dst[idx].float(), mask)
    return out * float(stride) if stride > 1 else out
