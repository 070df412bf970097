"""Point sampling (port of deeppointmap_tpu/ops/sampling.py): farthest-point
sampling and voxel-grid sampling.

`batched_fps` launches the CUDA kernel K1 (csrc/fps.cu) for tensors on the
GPU and runs `farthest_point_sampling_plain` for tensors on the CPU. Both
give the same indices, bit for bit.

Semantics (reference: network/encoder/utils.py:209-270, deterministic
start): start at the first valid point; invalid points are never picked
while a valid one remains; ties go to the lowest index; slots beyond the
number of valid points are marked invalid in `sel_valid`.
"""

from __future__ import annotations

import math

import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.ops.neighbors import f32

_NEG = -1.0
_INF = 3.4e38
#: K1 keeps a whole scan's coordinates in a block's shared memory (192 KB)
#: and sends a point's index in 14 bits of a message.
FPS_MAX_POINTS = 16384


def farthest_point_sampling_plain(xyz: torch.Tensor, valid: torch.Tensor,
                                  k: int) -> torch.Tensor:
    """Plain version of K1: xyz (B, N, 3) f32, valid (B, N) bool ->
    idx (B, k) int64. A Python loop of the update, batched over B."""
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    first = valid.to(torch.uint8).argmax(dim=1)  # first valid, else 0
    mind = torch.where(valid, torch.full_like(x, _INF),
                       torch.full_like(x, _NEG))
    mind[rows, first] = _NEG
    idx = torch.empty((b, k), dtype=torch.int64, device=xyz.device)
    idx[:, 0] = first
    last = first
    for i in range(1, k):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = (dx * dx + dy * dy) + dz * dz
        mind = torch.minimum(mind, d)
        mind[rows, last] = _NEG
        last = mind.argmax(dim=1)  # first occurrence of the max
        idx[:, i] = last
    return idx


def fps_shape(b: int, n: int, k: int) -> tuple:
    """Key under which K1's launches are counted by shape."""
    return b, n, k


def fps_cuda(xyz: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Launch K1 (csrc/fps.cu) on the current stream: xyz (B, N, 3) f32,
    valid (B, N) bool, both contiguous on one GPU -> idx (B, k) int64.

    Replaces the TPU kernel deeppointmap_tpu/ops/pallas_fps.py
    (fps_pallas_batched). Bound: neither bytes nor FLOPs (microseconds);
    the k - 1 serial steps, each ending in an argmax over the scan, take
    the time. The design spreads a scan over one warp, one block or a
    cluster of eight blocks by its size (at most 8 points a thread, in
    registers) and pays one exchange a step: every warp's winner travels
    as a 64-bit message through (distributed) shared memory, with no
    barrier (csrc/fps.cu says more)."""
    b, n, c = xyz.shape
    if c != 3 or xyz.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("fps_cuda takes xyz (B, N, 3) float32 and valid "
                         "(B, N) bool")
    if valid.shape != (b, n) or valid.device != xyz.device:
        raise ValueError("valid must be (B, N) on the device of xyz")
    if not (xyz.is_contiguous() and valid.is_contiguous()):
        raise ValueError("fps_cuda takes contiguous tensors")
    if not 1 <= n <= FPS_MAX_POINTS or k < 1:
        raise ValueError(f"fps_cuda needs 1 <= N <= {FPS_MAX_POINTS} and "
                         f"k >= 1 (got N={n}, k={k})")
    out = torch.empty((b, k), dtype=torch.int64, device=xyz.device)
    kernels.FPS.launch(xyz.data_ptr(), valid.data_ptr(), b, n, k,
                       out.data_ptr(), kernels.stream_ptr(xyz.device),
                       device=xyz.device, shape=fps_shape(b, n, k))
    return out


def batched_fps(xyz: torch.Tensor, valid: torch.Tensor, k: int):
    """(B, N, 3), (B, N) -> idx (B, k) int64, sel_valid (B, k) bool.

    GPU tensors go to K1 (or raise); CPU tensors take the plain version."""
    xyz = xyz.float().contiguous()
    valid = valid.contiguous()
    if xyz.is_cuda:
        idx = fps_cuda(xyz, valid, k)
    else:
        idx = farthest_point_sampling_plain(xyz, valid, k)
    n_valid = valid.sum(dim=1)
    sel_valid = torch.arange(k, device=xyz.device)[None, :] < n_valid[:, None]
    return idx, sel_valid


def voxel_sample(xyz: torch.Tensor, valid: torch.Tensor, k: int,
                 voxel_size: float = 0.3, sample_range: float = 1.0):
    """Voxel-grid sampling of one cloud: one representative per occupied
    voxel (the point nearest its voxel center), voxels ranked by point
    count, the k fullest kept (reference: network/encoder/utils.py:149-207;
    yaml `sample: {type: voxel, size, range}`). Points outside
    `sample_range` (and invalid ones) take part in no voxel.

    xyz (N, 3) normalized, valid (N,) -> idx (k,) int64 into xyz,
    sel_valid (k,). Plain PyTorch on either device, as the JAX package
    leaves it to XLA. The order is the JAX package's: by voxel id, then by
    distance to the voxel center, then by index (its stable lexsort);
    voxels of equal count rank by their first position in that order."""
    n = xyz.shape[0]
    xyz = xyz.float()
    big = 2.0 * sample_range
    p = torch.where(valid[:, None], xyz, torch.full_like(xyz, big))
    sq = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
    in_range = (sq <= f32(sample_range * sample_range)) & valid
    # grid coordinates from coordinates clamped to a static bound: a
    # clamped point is out of range already, and the bound keeps the id
    # space within int32
    dims_max = math.floor(4.0 * sample_range / voxel_size) + 2
    if float(dims_max) ** 3 >= 2 ** 31:
        raise ValueError(f"voxel grid id space {dims_max}^3 overflows "
                         f"int32; increase voxel_size (= {voxel_size}) or "
                         f"decrease sample_range (= {sample_range})")
    p = torch.clamp(p, -big, big)
    # float32 quotients taken in float64 and rounded once: correctly
    # rounded on either device (a float32 division on the GPU need not
    # be), so the CPU and the GPU floor every point into the same voxel
    vox = f32(voxel_size)
    div = lambda x: (x.double() / vox).float()
    pmin = p.min(dim=0).values
    dims = torch.floor(div(p.max(dim=0).values - pmin)) + 1.0
    rel = p - pmin
    vxyz = torch.floor(div(rel))
    vi = vxyz.to(torch.int32)
    di = dims.to(torch.int32)
    sentinel = torch.iinfo(torch.int32).max
    vid = vi[:, 0] + vi[:, 1] * di[0] + vi[:, 2] * di[0] * di[1]
    vid = torch.where(in_range, vid, torch.full_like(vid, sentinel))
    off = rel - vxyz * vox - f32(voxel_size / 2.0)
    dis = (off[:, 0] * off[:, 0] + off[:, 1] * off[:, 1]) \
        + off[:, 2] * off[:, 2]

    # lexicographic (vid, dis, index): stable sorts, the last key first
    order = torch.sort(dis, stable=True).indices
    order = order[torch.sort(vid[order], stable=True).indices]
    vs = vid[order]
    pos = torch.arange(n, device=xyz.device)
    first = torch.ones(n, dtype=torch.bool, device=xyz.device)
    first[1:] = vs[1:] != vs[:-1]
    firstpos = torch.where(first, pos, torch.full_like(pos, n))
    # the next run start after each position: a reverse running minimum
    nxt = torch.flip(torch.cummin(torch.flip(firstpos, [0]), 0).values, [0])
    nxt = torch.cat([nxt[1:], torch.full((1,), n, device=xyz.device,
                                         dtype=nxt.dtype)])
    score = torch.where(first & (vs < sentinel), nxt - pos,
                        torch.full_like(pos, -1))
    # lax.top_k: descending, ties to the lower position
    top = torch.sort(score, descending=True, stable=True)
    top_cnt, top_pos = top.values[:k], top.indices[:k]
    sel_valid = top_cnt > 0
    idx = torch.where(sel_valid, order[top_pos], torch.zeros_like(top_pos))
    return idx, sel_valid


def batched_voxel_sample(xyz, valid, k: int, voxel_size: float = 0.3,
                         sample_range: float = 1.0):
    """(B, N, 3), (B, N) -> idx (B, k) int64, sel_valid (B, k) bool."""
    outs = [voxel_sample(xyz[b], valid[b], k, voxel_size, sample_range)
            for b in range(xyz.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
