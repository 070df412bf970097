"""Transformer matcher decoder: attention, dual-softmax pairing, offsets and
the weighted Kabsch solve (port of deeppointmap_tpu/models/decoder.py).

Descriptors are channel-last (tokens, in_channel + 3) with xyz in the last
3 channels. Submodules carry the Flax scope names (models/weights.py).
`tpu.robust_register` replaces the trimmed Kabsch solve with the RANSAC
one (ops/kabsch.ransac_kabsch). The training entry point is not ported
yet.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from deeppointmap_tpu_torch.models.common import (LN_EPS, MultiHeadAttention,
                                                  sine_pos_embedding)
from deeppointmap_tpu_torch.ops.kabsch import (ransac_kabsch, top_k,
                                               weighted_kabsch)

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
        self.mlp0 = nn.Linear(emb_dim, emb_dim)
        self.mlp1 = nn.Linear(emb_dim, emb_dim)
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
        self.mlp0 = nn.Linear(emb_dim, emb_dim // 2)
        self.mlp1 = nn.Linear(emb_dim // 2, emb_dim // 4)
        self.mlp2 = nn.Linear(emb_dim // 4, emb_dim // 8)
        self.downsample = nn.Linear(emb_dim, emb_dim // 8)
        self.head = nn.Linear(emb_dim // 8, coor_dim)

    def forward(self, x):
        h = self.mlp2(F.relu(self.mlp1(F.relu(self.mlp0(x)))))
        return self.head(F.relu(h + self.downsample(x)))


class OverlapHead(nn.Module):
    """Shared token MLP -> mask-free mean pool -> concat -> MLP -> sigmoid
    (reference: network/decoder/heads.py:45-69)."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.mlp0 = nn.Linear(emb_dim, emb_dim)
        self.mlp1 = nn.Linear(emb_dim, emb_dim)
        self.proj0 = nn.Linear(2 * emb_dim, 2 * emb_dim)
        self.proj1 = nn.Linear(2 * emb_dim, 1)

    def forward(self, src_fea, dst_fea):
        s = self.mlp1(F.relu(self.mlp0(src_fea))).mean(dim=1)
        d = self.mlp1(F.relu(self.mlp0(dst_fea))).mean(dim=1)
        x = self.proj1(F.relu(self.proj0(torch.cat([s, d], dim=-1))))
        return torch.sigmoid(x)[..., 0]


class HeadMLP(nn.Module):
    """Linear-ReLU-Linear (reference: network/decoder/heads.py:6-19)."""

    def __init__(self, in_dim: int, emb_dim: int):
        super().__init__()
        self.dense0 = nn.Linear(in_dim, emb_dim)
        self.dense1 = nn.Linear(emb_dim, emb_dim)

    def forward(self, x):
        return self.dense1(F.relu(self.dense0(x)))


class Decoder(nn.Module):
    """Matcher decoder: `correlate`, `registration` and `loop_detection`."""

    def __init__(self, in_channel: int = 128, model_channel: int = 256,
                 attention_layers: int = 3, tau: float = 0.1,
                 eps_offset: float = 2.0, robust_register: bool = False):
        super().__init__()
        self.tau = tau
        self.eps_offset = eps_offset
        #: the RANSAC solve (tpu.robust_register) in place of the
        #: reference's trimmed one
        self.robust_register = robust_register
        self.model_channel = model_channel
        self.attention_layers = attention_layers
        self.projection = nn.Linear(in_channel, model_channel)
        for i in range(attention_layers):
            self.add_module(f"attn{i}",
                            DescriptorAttentionLayer(model_channel))
        self.similarity_head = HeadMLP(model_channel, model_channel)
        self.coarse_pairing_head = HeadMLP(in_channel, in_channel)
        self.offset_head = OffsetHead(model_channel * 2)
        self.loop_head = OverlapHead(model_channel)

    @classmethod
    def from_config(cls, args) -> "Decoder":
        d = args.decoder
        return cls(in_channel=d.in_channel, model_channel=d.model_channel,
                   attention_layers=d.attention_layers, tau=args.loss.tau,
                   eps_offset=args.loss.eps_offset,
                   robust_register=bool((args.get("tpu") or {}).get(
                       "robust_register", False)))

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
        sim = torch.where(pair_valid, sp @ dp.T, torch.full((), -1e9,
                                                            device=sp.device))
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


def num_pairs_for(m: int, n: int, num_sample: float = 0.5) -> int:
    """Pair count for the reference's num_sample (decoder.py:171-178)."""
    if isinstance(num_sample, float) and 0 < num_sample <= 1:
        total = int(num_sample * (m + n))
    else:
        total = int(num_sample)
    return max(total // 2, 1)
