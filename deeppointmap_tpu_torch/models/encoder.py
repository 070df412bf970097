"""PointNeXt-with-FPN descriptor encoder (port of
deeppointmap_tpu/models/encoder.py).

A stem projection, one Stage per entry of `npoint` (SetAbstraction plus
InvResMLP blocks) and `upsample_layers` FeaturePropagation layers; at the
full width (configs/infer/sample.yaml) 16384 points become 256 tokens of
128 features. Layout (B, N, C) with validity masks, as in the JAX package.

Samplers (yaml `encoder.sample`, per stage): FPS (ops/sampling.batched_fps,
kernel K1 on the GPU) or voxel-grid sampling (plain PyTorch). Queriers
(yaml `encoder.querier`): hybrid (the reference default; one shared
self-kNN per pyramid level, kernel K2 on the GPU), knn (K2) or ball (plain
PyTorch). The level graphs serve the hybrid querier only, as in the JAX
package.

Feature dtype (yaml `tpu.encoder_bf16`, `act_dtype`): `activation_dtype`
gives bfloat16 only when the option is on and the encoder runs on a CUDA
device, float32 otherwise, as the JAX package's trace-time gate gives
float32 off the TPU. The stem rounds the features to that dtype and every
block keeps the dtype of the features it is given, casting where the JAX
encoder casts: the grouped offsets (taken in float32), the residual's
identity, FeaturePropagation's concat (its 3-NN weights and weighted sum
stay float32); the output is float32. Geometry stays float32: coordinates,
sampling, neighbour queries and radius tests are those of the float32 run.

Matrix products (yaml `tpu.bf16`, `matmul_policy`, utils/precision.py):
under "bfloat16" the float32 features' linear layers take bfloat16
operands and return float32; bfloat16 features (above) are unchanged by it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deeppointmap_tpu_torch.models.common import MLP, Linear, linear_bf16
from deeppointmap_tpu_torch.ops.neighbors import (ball_query, f32,
                                                  group_points, hybrid_query,
                                                  knn)
from deeppointmap_tpu_torch.ops.sampling import (batched_fps,
                                                 batched_voxel_sample)
from deeppointmap_tpu_torch.utils import precision

#: grouping methods of the reference Querier (network/encoder/utils.py:
#: 18-43); '-t3d' suffixes name its CUDA twins and normalize away here
QUERIERS = ("knn", "ball", "hybrid")
#: per-stage sampler: (type, voxel_size, sample_range); size and range are
#: ignored for fps (reference: pointnext.py:21,30-35)
DEFAULT_SAMPLE = ("fps", 0.0, 0.0)


def activation_dtype(act_dtype: str, device: torch.device) -> torch.dtype:
    """The encoder's feature dtype: bfloat16 when `act_dtype` asks for it
    and the encoder runs on a CUDA device, float32 otherwise (the JAX
    gate, deeppointmap_tpu/models/encoder.py:417-418, runs float32 off the
    TPU)."""
    if act_dtype == "bfloat16" and device.type == "cuda":
        return torch.bfloat16
    return torch.float32


def _sample_batch(coor, valid, k: int, sample=DEFAULT_SAMPLE):
    """(B, N, 3), (B, N) -> idx (B, k), sel_valid (B, k)."""
    if sample[0] == "voxel":
        return batched_voxel_sample(coor, valid, k, voxel_size=sample[1],
                                    sample_range=sample[2])
    return batched_fps(coor, valid, k)


def _query_batch(points, centers, k: int, radius: float, points_valid,
                 querier: str = "hybrid"):
    """Neighbour grouping by the reference Querier's three methods: knn
    ignores the radius; ball keeps in-radius points (self-fill outside);
    hybrid = knn, then out-of-radius neighbours clamped to the nearest.
    -> idx (B, S, k)."""
    if querier == "knn":
        # with fewer than k valid points the tail carries the 1e9 marker;
        # those slots take the nearest neighbour, so that padded points
        # are never grouped
        idx, d2 = knn(points, centers, k, points_valid)
        return torch.where(d2 >= f32(1e8), idx[..., :1], idx)
    if querier == "ball":
        return ball_query(points, centers, k, radius, points_valid)
    if querier == "hybrid":
        return hybrid_query(points, centers, k, radius, points_valid)
    raise ValueError(f"unknown querier {querier!r}: use one of {QUERIERS}")


def _hybrid_from_graph(graph, k: int, radius: float, center_idx=None):
    """Hybrid grouping read out of a level graph (rows ascend by distance):
    optional row gather for subset centers, the first k columns, and
    out-of-radius entries clamped to the nearest neighbour (reference
    semantics: network/encoder/utils.py:113-123)."""
    gidx, gd2 = graph
    if center_idx is not None:
        gidx = group_points(gidx, center_idx)
        gd2 = group_points(gd2, center_idx)
    gi, gd = gidx[..., :k], gd2[..., :k]
    return torch.where(gd > f32(radius * radius), gi[..., :1], gi)


def _group_from_sweep(center_idx, valid, sweep, k: int, radius: float):
    """Stage-1 hybrid grouping served from the preprocess sweep's candidate
    lists (data/preprocess.py, sweep_k) instead of a fresh (S, N) query:
    gather each sampled center's candidates, re-mask them by the FINAL
    validity (the filters ran after the sweep), pick the k nearest survivors
    (ties to the earlier candidate), then apply the hybrid radius clamp.

    Equal to hybrid_query whenever fewer than Ks - k of a center's Ks
    candidates were dropped by the filters; beyond that the tail clamps to
    the nearest survivor, which max-pooled set abstraction tolerates.

    center_idx (B, S), valid (B, N), sweep = (idx (B, N, Ks), dist2
    (B, N, Ks) in normalized units, 1e9 for invalid candidates) ->
    group idx (B, S, k) int64."""
    cand_idx, cand_d2 = sweep
    cidx = group_points(cand_idx, center_idx)               # (B, S, Ks)
    cd2 = group_points(cand_d2, center_idx)
    ok = group_points(valid, cidx) & (cd2 < 1e8)
    d2m = torch.where(ok, cd2, torch.full_like(cd2, 1e9))
    # candidates ascend by distance already, so a stable sort keeps the
    # earlier of two equal ones, as lax.top_k does
    gd2, sel = torch.sort(d2m, dim=-1, stable=True)
    gd2, sel = gd2[..., :k], sel[..., :k]
    gidx = torch.gather(cidx, -1, sel)
    return torch.where(gd2 > f32(radius * radius), gidx[..., :1], gidx)


def _group(coor, fea, centers, group_idx, radius: float):
    """[grouped features | offsets / radius] (B, S, K, C + 3) in the
    features' dtype; the O(1) offsets are taken in float32, then cast."""
    g_coor = (group_points(coor, group_idx) - centers[:, :, None, :]) / radius
    return torch.cat([group_points(fea, group_idx), g_coor.to(fea.dtype)],
                     dim=-1)


class SetAbstraction(nn.Module):
    """Sample -> group -> MLP -> max-pool (reference: pointnext.py:8-64)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, bias: bool = True, sample=DEFAULT_SAMPLE,
                 querier: str = "hybrid"):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.sample, self.querier = tuple(sample), querier
        self.mlp = MLP(in_channel + 3, [in_channel * 2], bias=bias)

    def forward(self, coor, fea, valid, sweep=None, graph=None):
        # graph: the previous level's shared kNN over `coor`; the sampled
        # centers are a subset of its rows. sweep: the preprocess sweep's
        # candidate lists over `coor` (stage 1 only). Both serve the hybrid
        # querier only.
        idx, new_valid = _sample_batch(coor, valid, self.npoint, self.sample)
        new_coor = group_points(coor, idx)
        hybrid = self.querier == "hybrid"
        if sweep is not None and hybrid:
            group_idx = _group_from_sweep(idx, valid, sweep, self.nsample,
                                          self.radius)
        elif graph is not None and hybrid:
            group_idx = _hybrid_from_graph(graph, self.nsample, self.radius,
                                           center_idx=idx)
        else:
            group_idx = _query_batch(coor, new_coor, self.nsample,
                                     self.radius, valid, self.querier)
        g = self.mlp(_group(coor, fea, new_coor, group_idx, self.radius))
        return new_coor, g.amax(dim=2), new_valid


class LocalAggregation(nn.Module):
    """Group around every point, MLP, max-pool
    (reference: pointnext.py:67-109)."""

    def __init__(self, radius: float, nsample: int, in_channel: int,
                 bias: bool = True, querier: str = "hybrid"):
        super().__init__()
        self.radius, self.nsample, self.querier = radius, nsample, querier
        self.mlp = MLP(in_channel + 3, [in_channel], bias=bias)

    def forward(self, coor, fea, valid, graph=None):
        if graph is not None and self.querier == "hybrid":
            group_idx = _hybrid_from_graph(graph, self.nsample, self.radius)
        else:
            group_idx = _query_batch(coor, coor, self.nsample, self.radius,
                                     valid, self.querier)
        g = self.mlp(_group(coor, fea, coor, group_idx, self.radius))
        return g.amax(dim=2)


class InvResMLP(nn.Module):
    """Inverted-residual block (reference: pointnext.py:112-138)."""

    def __init__(self, radius: float, nsample: int, in_channel: int,
                 expansion: int = 4, bias: bool = True,
                 querier: str = "hybrid"):
        super().__init__()
        self.la = LocalAggregation(radius, nsample, in_channel, bias,
                                   querier)
        self.pw_conv = MLP(in_channel, [in_channel * expansion, in_channel],
                           bias=bias, drop_last_act=True)

    def forward(self, coor, fea, valid, graph=None):
        out = self.pw_conv(self.la(coor, fea, valid, graph=graph))
        return torch.relu(out + fea.to(out.dtype))


class Stage(nn.Module):
    """SetAbstraction + (len(radius_list) - 1) InvResMLP blocks
    (reference: pointnext.py:141-173)."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_channel: int,
                 expansion: int = 4, bias: bool = True,
                 sample=DEFAULT_SAMPLE, querier: str = "hybrid"):
        super().__init__()
        self.sa = SetAbstraction(npoint, radius_list[0], nsample_list[0],
                                 in_channel, bias, sample, querier)
        self.n_irm = len(radius_list) - 1
        for i in range(1, len(radius_list)):
            self.add_module(f"irm{i - 1}", InvResMLP(
                radius_list[i], nsample_list[i], in_channel * 2, expansion,
                bias, querier))

    def forward(self, coor, fea, valid, sweep=None, in_graph=None,
                graph_k: int = 0):
        """sweep / in_graph: the preprocess sweep's candidates, or the
        previous level's shared kNN, over the input points (either serves
        the SA query); graph_k > 0 builds this level's own shared kNN over
        the sampled points, returned as the 4th output."""
        coor, fea, valid = self.sa(coor, fea, valid, sweep=sweep,
                                   graph=in_graph)
        graph = knn(coor, coor, graph_k, valid) if graph_k > 0 else None
        for i in range(self.n_irm):
            fea = getattr(self, f"irm{i}")(coor, fea, valid, graph=graph)
        return coor, fea, valid, graph


class FeaturePropagation(nn.Module):
    """Inverse-distance-weighted 3-NN upsampling + MLP
    (reference: pointnext.py:176-218)."""

    def __init__(self, in_channel: int, mlp: Sequence[int], bias: bool = True):
        super().__init__()
        self.mlp = MLP(in_channel, mlp, bias=bias)

    def forward(self, coor1, coor2, fea1, fea2, valid2):
        # interpolate fea2 (B, S, D2) at coor1 (B, N, 3); padded deep
        # points sit at 1e9 and are never among the 3 nearest
        idx, d2 = knn(coor2, coor1, 3, valid2)
        w = 1.0 / torch.clamp(d2, min=1e-8)
        w = w / w.sum(dim=-1, keepdim=True)
        # bfloat16 features times the float32 weights sum in float32
        inter = (group_points(fea2, idx) * w[..., None]).sum(dim=2)
        return self.mlp(torch.cat([fea1, inter.to(fea1.dtype)], dim=-1))


class Encoder(nn.Module):
    """forward(points (B, N, 3+), valid (B, N)[, sweep]) -> (coor (B, S, 3),
    fea (B, S, out_channel) float32, valid (B, S)). Config fields mirror
    the yaml `encoder:` tree; `act_dtype` ("float32" | "bfloat16") is
    `tpu.encoder_bf16`; `matmul_policy` is utils/precision.py's policy
    for the linear layers."""

    def __init__(self, npoint=(4096, 1024, 256, 64, 16),
                 radius_list=((0.05, 0.1), (0.1, 0.2), (0.2, 0.4, 0.4),
                              (0.4, 0.8), (0.8, 1.6)),
                 nsample_list=((32, 32), (32, 32), (32, 32, 32), (32, 32),
                               (16, 16)),
                 in_channel: int = 3, out_channel: int = 128, width: int = 16,
                 expansion: int = 4, upsample_layers: int = 2,
                 bias: bool = True, sample=None, querier: str = "hybrid",
                 act_dtype: str = "float32",
                 matmul_policy: str = precision.UNCHANGED):
        super().__init__()
        if act_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"act_dtype {act_dtype!r}: use 'float32' or "
                             "'bfloat16'")
        self.act_dtype = act_dtype
        self.npoint = tuple(npoint)
        sample = tuple(tuple(x) for x in (sample or ()))
        sample += (DEFAULT_SAMPLE,) * (len(self.npoint) - len(sample))
        self.querier = querier
        self.nsample_list = tuple(tuple(n) for n in nsample_list)
        self.in_channel = in_channel
        self.upsample_layers = upsample_layers
        self.point_mlp0 = Linear(in_channel, width)
        widths = [width]
        for i in range(len(self.npoint)):
            self.add_module(f"down{i}", Stage(
                self.npoint[i], radius_list[i], nsample_list[i], widths[-1],
                expansion, bias, sample[i], querier))
            widths.append(widths[-1] * 2)
        w = fea2_ch = widths[-1]
        for i in range(upsample_layers):
            up_out = max(out_channel, w // 2)
            fea1_ch = widths[len(self.npoint) - i - 1]
            self.add_module(f"up{i}", FeaturePropagation(
                fea1_ch + fea2_ch, (up_out, up_out), bias))
            fea2_ch = up_out
            w //= 2
        precision.set_policy(self, matmul_policy)

    @classmethod
    def from_config(cls, args,
                    matmul_policy: str = precision.UNCHANGED) -> "Encoder":
        e = args.encoder
        norm = str(e.get("norm", "LN")).lower()
        if norm != "ln":
            raise ValueError(f"only LayerNorm is supported (got {norm!r})")
        sample = []
        for s in e.sample:
            kind = str(s["type"])
            if kind.startswith("fps"):       # fps / fps-t3d are one op here
                sample.append(DEFAULT_SAMPLE)
            elif kind == "voxel":
                sample.append(("voxel", float(s["size"]), float(s["range"])))
            else:
                raise ValueError(f"unsupported sampler {kind!r}: use 'fps', "
                                 "'fps-t3d' or 'voxel'")
        if len(sample) == 1:
            sample = sample * len(e.npoint)
        if len(sample) != len(e.npoint):
            raise ValueError(f"{len(sample)} samplers for "
                             f"{len(e.npoint)} stages")
        querier = str(e.get("querier", "hybrid")).lower()
        querier = querier.removesuffix("-t3d")
        if querier not in QUERIERS:
            raise ValueError(f"unknown encoder.querier {querier!r}: use one "
                             f"of {QUERIERS}")
        return cls(npoint=tuple(e.npoint), radius_list=e.radius_list,
                   nsample_list=e.nsample_list, in_channel=e.in_channel,
                   out_channel=e.out_channel, width=e.width,
                   expansion=e["expansion"],
                   upsample_layers=e.upsample_layers,
                   bias=e.get("bias", True), sample=tuple(sample),
                   querier=querier,
                   act_dtype="bfloat16" if (args.get("tpu") or {}).get(
                       "encoder_bf16", False) else "float32",
                   matmul_policy=matmul_policy)

    def forward(self, points, valid, sweep=None):
        """sweep: optional (idx (B, N, Ks), dist2 (B, N, Ks)) candidate
        graph from device preprocessing (sweep_k > 0), in the units of
        `points`; it serves the FIRST stage's grouping without a fresh
        (npoint0, N) query."""
        coor = points[..., :3].float()
        fea = points[..., :self.in_channel].float()
        if activation_dtype(self.act_dtype, points.device) == torch.bfloat16:
            fea = linear_bf16(self.point_mlp0, fea)
        else:
            fea = self.point_mlp0(fea)
        levels = [(coor, fea, valid)]
        graph = None
        n = len(self.npoint)
        for i in range(n):
            # shared-graph width (hybrid querier): the widest consumer among
            # this level's InvResMLP blocks and the next stage's SA
            graph_k = 0
            if self.querier == "hybrid":
                own = max(self.nsample_list[i][1:], default=0)
                nxt = self.nsample_list[i + 1][0] if i + 1 < n else 0
                graph_k = max(own, nxt)
            c, f, v, graph = getattr(self, f"down{i}")(
                *levels[-1], sweep=sweep if i == 0 else None,
                in_graph=graph, graph_k=graph_k)
            levels.append((c, f, v))

        c, f, v = levels[-1]
        for i in range(self.upsample_layers):
            c1, f1, v1 = levels[n - i - 1]
            f = getattr(self, f"up{i}")(c1, c, f1, f, v)
            c, v = c1, v1
        return c, f.float(), v
