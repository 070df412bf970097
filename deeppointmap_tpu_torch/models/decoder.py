"""Transformer matcher decoder: attention, dual-softmax pairing, offsets and
the weighted Kabsch solve (port of deeppointmap_tpu/models/decoder.py).

Descriptors are channel-last (tokens, in_channel + 3) with xyz in the last
3 channels. Submodules carry the Flax scope names (models/weights.py).
`tpu.robust_register` replaces the trimmed Kabsch solve with the RANSAC
one (ops/kabsch.ransac_kabsch). `train_forward` is the training entry
point (models/loss.py consumes its dict).

`matmul_policy` (utils/precision.py, set on every layer by the engine or
the trainer) governs the heads, the attention and the similarity product;
the products over x, y, z (train_forward's GT moves) and the solve stay
float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from deeppointmap_tpu_torch.models.common import (LN_EPS, Linear,
                                                  MultiHeadAttention,
                                                  sine_pos_embedding)
from deeppointmap_tpu_torch.ops.kabsch import (ransac_kabsch, top_k,
                                               weighted_kabsch)
from deeppointmap_tpu_torch.ops.neighbors import group_points
from deeppointmap_tpu_torch.utils import precision

_CONF_TOPK = 30  # confidence = mean of the first 30 inlier confidences
                 # (reference: system/modules/utils.py:18)


class DescriptorAttentionLayer(nn.Module):
    """Shared self-attention on src and dst, shared bidirectional
    cross-attention, MLP; the positional embedding is re-added before each
    attention (reference: network/decoder/descriptor_attention.py:24-51)."""

    def __init__(self, emb_dim: int, num_heads: int = 8):
        super().__init__()
        self.self_attn = MultiHeadAttention(emb_dim, num_heads)
        self.cross_attn = MultiHeadAttention(emb_dim, num_heads)
        self.mlp0 = Linear(emb_dim, emb_dim)
        self.mlp1 = Linear(emb_dim, emb_dim)
        self.norm1 = nn.LayerNorm(emb_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(emb_dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(emb_dim, eps=LN_EPS)

    def forward(self, src, dst, src_pos, dst_pos, src_valid, dst_valid):
        src = src + src_pos
        dst = dst + dst_pos
        src = self.norm1(src + self.self_attn(src, src, src, src_valid))
        dst = self.norm1(dst + self.self_attn(dst, dst, dst, dst_valid))
        src = src + src_pos
        dst = dst + dst_pos
        src_out = self.cross_attn(src, dst, dst, dst_valid)
        dst_out = self.cross_attn(dst, src, src, src_valid)
        src = self.norm2(src + src_out)
        dst = self.norm2(dst + dst_out)
        src = self.norm3(self.mlp1(F.relu(self.mlp0(src))) + src)
        dst = self.norm3(self.mlp1(F.relu(self.mlp0(dst))) + dst)
        return src, dst


class OffsetHead(nn.Module):
    """Residual MLP -> 3-d offset (reference: network/decoder/heads.py:22-42)."""

    def __init__(self, emb_dim: int, coor_dim: int = 3):
        super().__init__()
        self.mlp0 = Linear(emb_dim, emb_dim // 2)
        self.mlp1 = Linear(emb_dim // 2, emb_dim // 4)
        self.mlp2 = Linear(emb_dim // 4, emb_dim // 8)
        self.downsample = Linear(emb_dim, emb_dim // 8)
        self.head = Linear(emb_dim // 8, coor_dim)

    def forward(self, x):
        h = self.mlp2(F.relu(self.mlp1(F.relu(self.mlp0(x)))))
        return self.head(F.relu(h + self.downsample(x)))


class OverlapHead(nn.Module):
    """Shared token MLP -> mask-free mean pool -> concat -> MLP -> sigmoid
    (reference: network/decoder/heads.py:45-69)."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.mlp0 = Linear(emb_dim, emb_dim)
        self.mlp1 = Linear(emb_dim, emb_dim)
        self.proj0 = Linear(2 * emb_dim, 2 * emb_dim)
        self.proj1 = Linear(2 * emb_dim, 1)

    def forward(self, src_fea, dst_fea):
        s = self.mlp1(F.relu(self.mlp0(src_fea))).mean(dim=1)
        d = self.mlp1(F.relu(self.mlp0(dst_fea))).mean(dim=1)
        x = self.proj1(F.relu(self.proj0(torch.cat([s, d], dim=-1))))
        return torch.sigmoid(x)[..., 0]


class HeadMLP(nn.Module):
    """Linear-ReLU-Linear (reference: network/decoder/heads.py:6-19)."""

    def __init__(self, in_dim: int, emb_dim: int):
        super().__init__()
        self.dense0 = Linear(in_dim, emb_dim)
        self.dense1 = Linear(emb_dim, emb_dim)

    def forward(self, x):
        return self.dense1(F.relu(self.dense0(x)))


class Decoder(nn.Module):
    """Matcher decoder: `correlate`, `registration`, `loop_detection` and
    `train_forward`. `matmul_policy`: utils/precision.py's policy for every
    governed product of the decoder."""

    matmul_policy = precision.UNCHANGED

    def __init__(self, in_channel: int = 128, model_channel: int = 256,
                 attention_layers: int = 3, tau: float = 0.1,
                 eps_offset: float = 2.0, robust_register: bool = False,
                 matmul_policy: str = precision.UNCHANGED):
        super().__init__()
        self.tau = tau
        self.eps_offset = eps_offset
        #: the RANSAC solve (tpu.robust_register) in place of the
        #: reference's trimmed one
        self.robust_register = robust_register
        self.model_channel = model_channel
        self.attention_layers = attention_layers
        self.projection = Linear(in_channel, model_channel)
        for i in range(attention_layers):
            self.add_module(f"attn{i}",
                            DescriptorAttentionLayer(model_channel))
        self.similarity_head = HeadMLP(model_channel, model_channel)
        self.coarse_pairing_head = HeadMLP(in_channel, in_channel)
        self.offset_head = OffsetHead(model_channel * 2)
        self.loop_head = OverlapHead(model_channel)
        precision.set_policy(self, matmul_policy)

    @classmethod
    def from_config(cls, args,
                    matmul_policy: str = precision.UNCHANGED) -> "Decoder":
        d = args.decoder
        return cls(in_channel=d.in_channel, model_channel=d.model_channel,
                   attention_layers=d.attention_layers, tau=args.loss.tau,
                   eps_offset=args.loss.eps_offset,
                   robust_register=bool((args.get("tpu") or {}).get(
                       "robust_register", False)),
                   matmul_policy=matmul_policy)

    def correlate(self, src_desc, dst_desc, src_valid, dst_valid):
        """(B, M, C+3) x (B, N, C+3) -> correlated (B, M, mc), (B, N, mc)
        (reference: decoder.py:145-162)."""
        src_pos = sine_pos_embedding(src_desc[..., -3:], self.model_channel)
        dst_pos = sine_pos_embedding(dst_desc[..., -3:], self.model_channel)
        src = self.projection(src_desc[..., :-3])
        dst = self.projection(dst_desc[..., :-3])
        for i in range(self.attention_layers):
            src, dst = getattr(self, f"attn{i}")(src, dst, src_pos, dst_pos,
                                                 src_valid, dst_valid)
        return src, dst

    def registration(self, src_desc, dst_desc, src_valid, dst_valid,
                     num_pairs: int, num_pairs_actual=None):
        """Pairwise registration, unbatched: src (M, C+3), dst (N, C+3) ->
        (R (3, 3), t (3,), confidence, rmse, num_inliers), solving
        dst ~= R src + t. `num_pairs` is the pair count for the (bucketed)
        shapes; pairs ranked beyond `num_pairs_actual`, the count for the
        real sizes, are masked out of the solve (decoder.py:246-247)."""
        m, n = src_desc.shape[0], dst_desc.shape[0]
        src_fea, dst_fea = self.correlate(src_desc[None], dst_desc[None],
                                          src_valid[None], dst_valid[None])
        src_fea, dst_fea = src_fea[0], dst_fea[0]
        src_xyz, dst_xyz = src_desc[:, -3:], dst_desc[:, -3:]

        # dual-softmax pairing (reference: decoder.py:181-192)
        sp = F.normalize(self.similarity_head(src_fea), dim=-1, eps=1e-12)
        dp = F.normalize(self.similarity_head(dst_fea), dim=-1, eps=1e-12)
        pair_valid = src_valid[:, None] & dst_valid[None, :]
        sim = torch.where(pair_valid,
                          precision.matmul(sp, dp.T, self.matmul_policy),
                          torch.full((), -1e9, device=sp.device))
        conf_mat = torch.softmax(sim / self.tau, dim=1) \
            * torch.softmax(sim / self.tau, dim=0) * pair_valid
        conf, flat_idx = top_k(conf_mat.reshape(m * n), num_pairs)
        si = flat_idx // n
        di = flat_idx % n

        # offset-corrected correspondence sets (reference: decoder.py:202-225)
        sf, df = src_fea[si], dst_fea[di]
        sx, dx = src_xyz[si], dst_xyz[di]
        off_s2d = self.offset_head(torch.cat([sf, df], dim=-1))
        off_d2s = self.offset_head(torch.cat([df, sf], dim=-1))
        src_coor = torch.cat([sx + off_s2d, sx], dim=0)
        dst_coor = torch.cat([dx, dx + off_d2s], dim=0)
        conf2 = torch.cat([conf, conf], dim=0)
        eps2 = float(self.eps_offset ** 2)
        ok_s2d = (off_s2d ** 2).sum(-1) <= eps2
        ok_d2s = (off_d2s ** 2).sum(-1) <= eps2
        pair_ok = src_valid[si] & dst_valid[di]
        if num_pairs_actual is not None:
            pair_ok = pair_ok & (torch.arange(num_pairs, device=si.device)
                                 < num_pairs_actual)
        valid2 = torch.cat([ok_s2d & pair_ok, ok_d2s & pair_ok], dim=0)

        solver = ransac_kabsch if self.robust_register else weighted_kabsch
        R, t, inlier, rmse = solver(src_coor, dst_coor, conf2, valid2)

        # confidence: mean of the FIRST 30 inlier confidences in pair order
        rank = torch.cumsum(inlier.int(), dim=0) - 1
        take = inlier & (rank < _CONF_TOPK)
        denom = torch.clamp(take.float().sum(), min=1.0)
        confidence = (conf2 * take).sum() / denom
        return R, t, confidence, rmse, inlier.sum()

    def loop_detection(self, src_desc, dst_desc, src_valid, dst_valid):
        """Batched overlap probability: (B, M, C+3) x (B, N, C+3) -> (B,)
        (reference: decoder.py:129-143)."""
        return self.loop_head(*self.correlate(src_desc, dst_desc, src_valid,
                                              dst_valid))

    def train_forward(self, src_desc, dst_desc, src_valid, dst_valid,
                      gt_R, gt_t, max_pairs: int):
        """Training features and offset residuals (reference:
        decoder.py:40-89), fixed-shape: (B, M, C+3) x (B, N, C+3), GT
        src -> dst pose gt_R (B, 3, 3), gt_t (B, 3) -> dict of the pairing
        and coarse features, the offset residuals of `max_pairs` pairs per
        batch element and their validity.

        The pairs are those of `first_pairs` over the proximity mask."""
        src_coarse = self.coarse_pairing_head(src_desc[..., :-3])
        dst_coarse = self.coarse_pairing_head(dst_desc[..., :-3])
        src_fea, dst_fea = self.correlate(src_desc, dst_desc, src_valid,
                                          dst_valid)
        src_xyz, dst_xyz = src_desc[..., -3:], dst_desc[..., -3:]
        src_pair_fea = self.similarity_head(src_fea)
        dst_pair_fea = self.similarity_head(dst_fea)

        # GT-aligned proximity pairs (reference: decoder.py:62-76)
        src_gt = torch.einsum("bij,bnj->bni", gt_R, src_xyz) \
            + gt_t[:, None, :]
        d2 = ((src_gt[:, :, None, :] - dst_xyz[:, None, :, :]) ** 2).sum(-1)
        near = (d2 <= float(self.eps_offset ** 2)) \
            & src_valid[:, :, None] & dst_valid[:, None, :]
        n = near.shape[2]
        flat, pair_valid = first_pairs(near, max_pairs)
        si, di = flat // n, flat % n

        sf, df = group_points(src_fea, si), group_points(dst_fea, di)
        s_gt, d_gt = group_points(src_gt, si), group_points(dst_xyz, di)
        off_s2d = self.offset_head(torch.cat([sf, df], dim=-1))
        off_d2s = self.offset_head(torch.cat([df, sf], dim=-1))
        # GT offsets (reference: decoder.py:78-81): the src offset lives in
        # the src frame, so the gap is rotated back by gt_R^T
        gap = d_gt - s_gt
        src_off_gt = torch.einsum("bji,bpj->bpi", gt_R, gap)
        dst_off_gt = -gap
        return {
            "src_pairing_fea": src_pair_fea, "dst_pairing_fea": dst_pair_fea,
            "src_coarse_fea": src_coarse, "dst_coarse_fea": dst_coarse,
            "src_offset_res": off_s2d - src_off_gt,
            "dst_offset_res": off_d2s - dst_off_gt,
            "pair_valid": pair_valid,
        }


def first_pairs(near: torch.Tensor, k: int):
    """jax.lax.top_k(near.reshape(B, M * N).astype(f32), k) as the JAX
    decoder's train_forward takes it: the first k True entries of each
    (M, N) mask in flat (m * N + n) order, then the first False ones.
    torch.topk makes no promise about ties; a stable descending sort keeps
    equal entries in index order. -> (flat index (B, k) int64, whether the
    entry is True (B, k))."""
    b = near.shape[0]
    vals, flat = torch.sort(near.reshape(b, -1).float(), dim=-1,
                            descending=True, stable=True)
    return flat[:, :k], vals[:, :k] > 0.5


def num_pairs_for(m: int, n: int, num_sample: float = 0.5) -> int:
    """Pair count for the reference's num_sample (decoder.py:171-178)."""
    if isinstance(num_sample, float) and 0 < num_sample <= 1:
        total = int(num_sample * (m + n))
    else:
        total = int(num_sample)
    return max(total // 2, 1)
