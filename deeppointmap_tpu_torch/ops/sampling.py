"""Farthest-point sampling (port of deeppointmap_tpu/ops/sampling.py).

`batched_fps` launches the CUDA kernel K1 (csrc/fps.cu) for tensors on the
GPU and runs `farthest_point_sampling_plain` for tensors on the CPU. Both
give the same indices, bit for bit.

Semantics (reference: network/encoder/utils.py:209-270, deterministic
start): start at the first valid point; invalid points are never picked
while a valid one remains; ties go to the lowest index; slots beyond the
number of valid points are marked invalid in `sel_valid`.
"""

from __future__ import annotations

import torch

from deeppointmap_tpu_torch import kernels

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
                       shape=fps_shape(b, n, k))
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
