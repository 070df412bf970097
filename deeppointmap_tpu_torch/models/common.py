"""Shared network blocks, channel-last (port of
deeppointmap_tpu/models/common.py).

Submodules are named after the Flax scopes (`dense{i}`, `norm{i}`,
`in_proj_weight`, `out_proj`) so that a Flax checkpoint maps onto the
state dict by renaming alone (models/weights.py). LayerNorm uses Flax's
epsilon, 1e-6.

`MLP` computes in the dtype of its input: float32, or bfloat16 on the
encoder's feature path under `tpu.encoder_bf16` (models/encoder.py), where
`linear_bf16` and `layer_norm_bf16` round where Flax's `nn.Dense` and
`nn.LayerNorm` with `dtype=bfloat16` do. Parameters stay float32.

`Linear` and `MultiHeadAttention` take the `tpu.bf16` rule
(utils/precision.py) from their `matmul_policy`, which the engine and the
trainer set on the whole model: under "bfloat16" their float32 products
take bfloat16 operands and return float32; under the two float32 policies
they are F.linear and torch.bmm, whose results are bit-equal to the einsum
attention the port ran before the rule
(tests/test_torch_precision_cuda.py, on the CPU and the card).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from deeppointmap_tpu_torch.utils import precision

LN_EPS = 1e-6


class Linear(nn.Linear):
    """nn.Linear whose product takes the model's matmul policy (Flax's
    `nn.Dense` at default precision)."""

    matmul_policy = precision.UNCHANGED

    def forward(self, x):
        return precision.linear(x, self.weight, self.bias,
                                self.matmul_policy)


class MLP(nn.Module):
    """Linear-LayerNorm-ReLU stack == reference `build_mlp(norm='ln')`
    (network/encoder/utils.py:358-413), acting on the last axis."""

    def __init__(self, in_channel: int, channels: Sequence[int],
                 bias: bool = True, drop_last_act: bool = False):
        super().__init__()
        self.n = len(channels)
        self.drop_last_act = drop_last_act
        for i, ch in enumerate(channels):
            self.add_module(f"dense{i}", Linear(in_channel, ch, bias=bias))
            self.add_module(f"norm{i}", nn.LayerNorm(ch, eps=LN_EPS))
            in_channel = ch

    def forward(self, x):
        bf16 = x.dtype == torch.bfloat16
        for i in range(self.n):
            dense, norm = getattr(self, f"dense{i}"), getattr(self, f"norm{i}")
            x = layer_norm_bf16(norm, linear_bf16(dense, x)) if bf16 \
                else norm(dense(x))
            if not (self.drop_last_act and i == self.n - 1):
                x = F.relu(x)
        return x


def linear_bf16(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Flax `nn.Dense(dtype=bfloat16)`: the input, the float32 kernel and
    the bias rounded to bfloat16; the product (float32 accumulation)
    rounded to bfloat16, then the bias added in bfloat16."""
    bf = torch.bfloat16
    y = F.linear(x.to(bf), layer.weight.to(bf))
    return y if layer.bias is None else y + layer.bias.to(bf)


def layer_norm_bf16(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Flax `nn.LayerNorm(dtype=bfloat16)` (flax/linen/normalization.py
    `_compute_stats`, `_normalize`): mean and variance in float32 with the
    fast variance E[x^2] - E[x]^2 clipped at 0, the float32 scale and bias
    applied in float32, one rounding to bfloat16 at the end.
    (`F.layer_norm` on bfloat16 would round the scale and bias first.)"""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight
    return ((xf - mu) * mul + norm.bias).to(torch.bfloat16)


class MultiHeadAttention(nn.Module):
    """torch `nn.MultiheadAttention` arithmetic (packed q|k|v in-projection)
    written out as in the JAX package: the projections, then the logits and
    attn.V as batched products of contiguous (B * H, N, d) operands, under
    the module's `matmul_policy`. `key_valid` (B, N_k) masks logits to
    -1e9; every row has a valid key."""

    matmul_policy = precision.UNCHANGED

    def __init__(self, emb_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * emb_dim, emb_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * emb_dim))
        self.out_proj = Linear(emb_dim, emb_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, key_valid=None):
        b, n_q, c = q.shape
        n_k = k.shape[1]
        h = self.num_heads
        d = c // h
        w, bias = self.in_proj_weight, self.in_proj_bias
        policy = self.matmul_policy

        def heads(x, rows, part):
            y = precision.linear(x, w[part * c:(part + 1) * c],
                                 bias[part * c:(part + 1) * c], policy)
            return y.reshape(b, rows, h, d).transpose(1, 2).reshape(
                b * h, rows, d)

        q_p, k_p, v_p = heads(q, n_q, 0), heads(k, n_k, 1), heads(v, n_k, 2)
        logits = precision.bmm(q_p, k_p.transpose(1, 2), policy) \
            / math.sqrt(d)
        logits = logits.reshape(b, h, n_q, n_k)
        if key_valid is not None:
            logits = torch.where(key_valid[:, None, None, :], logits,
                                 torch.full_like(logits, -1e9))
        attn = torch.softmax(logits, dim=-1).reshape(b * h, n_q, n_k)
        out = precision.bmm(attn, v_p, policy).reshape(b, h, n_q, d)
        return self.out_proj(out.transpose(1, 2).reshape(b, n_q, c))


def sine_pos_embedding(xyz: torch.Tensor, emb_dim: int,
                       temperature: float = 10000.0,
                       scale: float = math.pi) -> torch.Tensor:
    """Sine/cos embedding of coordinates, (B, N, 3) -> (B, N, emb_dim),
    zero-padding the emb_dim % 6 leftover channels (reference:
    network/decoder/descriptor_attention.py:66-83)."""
    in_dim = xyz.shape[-1]
    num_feats = emb_dim // in_dim // 2 * 2
    pad = emb_dim - num_feats * in_dim
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=xyz.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    pos_div = (xyz.float() * scale)[..., None] / dim_t   # (B, N, 3, nf)
    emb = torch.stack([torch.sin(pos_div[..., 0::2]),
                       torch.cos(pos_div[..., 1::2])], dim=-1)
    emb = emb.reshape(*xyz.shape[:-1], num_feats * in_dim)
    if pad:
        emb = F.pad(emb, (0, pad))
    return emb
