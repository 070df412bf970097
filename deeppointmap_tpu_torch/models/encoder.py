"""PointNeXt-with-FPN descriptor encoder (port of
deeppointmap_tpu/models/encoder.py).

A stem projection, one Stage per entry of `npoint` (SetAbstraction plus
InvResMLP blocks) and `upsample_layers` FeaturePropagation layers; at the
full width (configs/infer/sample.yaml) 16384 points become 256 tokens of
128 features. Layout (B, N, C) with validity masks, as in the JAX package.

Sampling is FPS (ops/sampling.batched_fps, kernel K1 on the GPU); grouping
is the hybrid querier with one shared self-kNN per pyramid level
(LEVEL_GRAPH_REUSE, kernel K2 on the GPU). Voxel sampling and the knn /
ball queriers are not ported yet and are refused by `from_config`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deeppointmap_tpu_torch.models.common import MLP
from deeppointmap_tpu_torch.ops.neighbors import (f32, group_points,
                                                  hybrid_query, knn)
from deeppointmap_tpu_torch.ops.sampling import batched_fps


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
    """[grouped features | offsets / radius] (B, S, K, C + 3)."""
    g_coor = (group_points(coor, group_idx) - centers[:, :, None, :]) / radius
    return torch.cat([group_points(fea, group_idx), g_coor], dim=-1)


class SetAbstraction(nn.Module):
    """Sample -> group -> MLP -> max-pool (reference: pointnext.py:8-64)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, bias: bool = True):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp = MLP(in_channel + 3, [in_channel * 2], bias=bias)

    def forward(self, coor, fea, valid, sweep=None, graph=None):
        # graph: the previous level's shared kNN over `coor`; the sampled
        # centers are a subset of its rows. sweep: the preprocess sweep's
        # candidate lists over `coor` (stage 1 only)
        idx, new_valid = batched_fps(coor, valid, self.npoint)
        new_coor = group_points(coor, idx)
        if sweep is not None:
            group_idx = _group_from_sweep(idx, valid, sweep, self.nsample,
                                          self.radius)
        elif graph is not None:
            group_idx = _hybrid_from_graph(graph, self.nsample, self.radius,
                                           center_idx=idx)
        else:
            group_idx = hybrid_query(coor, new_coor, self.nsample,
                                     self.radius, valid)
        g = self.mlp(_group(coor, fea, new_coor, group_idx, self.radius))
        return new_coor, g.amax(dim=2), new_valid


class LocalAggregation(nn.Module):
    """Group around every point, MLP, max-pool
    (reference: pointnext.py:67-109)."""

    def __init__(self, radius: float, nsample: int, in_channel: int,
                 bias: bool = True):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.mlp = MLP(in_channel + 3, [in_channel], bias=bias)

    def forward(self, coor, fea, valid, graph=None):
        if graph is not None:
            group_idx = _hybrid_from_graph(graph, self.nsample, self.radius)
        else:
            group_idx = hybrid_query(coor, coor, self.nsample, self.radius,
                                     valid)
        g = self.mlp(_group(coor, fea, coor, group_idx, self.radius))
        return g.amax(dim=2)


class InvResMLP(nn.Module):
    """Inverted-residual block (reference: pointnext.py:112-138)."""

    def __init__(self, radius: float, nsample: int, in_channel: int,
                 expansion: int = 4, bias: bool = True):
        super().__init__()
        self.la = LocalAggregation(radius, nsample, in_channel, bias)
        self.pw_conv = MLP(in_channel, [in_channel * expansion, in_channel],
                           bias=bias, drop_last_act=True)

    def forward(self, coor, fea, valid, graph=None):
        out = self.pw_conv(self.la(coor, fea, valid, graph=graph))
        return torch.relu(out + fea)


class Stage(nn.Module):
    """SetAbstraction + (len(radius_list) - 1) InvResMLP blocks
    (reference: pointnext.py:141-173)."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_channel: int,
                 expansion: int = 4, bias: bool = True):
        super().__init__()
        self.sa = SetAbstraction(npoint, radius_list[0], nsample_list[0],
                                 in_channel, bias)
        self.n_irm = len(radius_list) - 1
        for i in range(1, len(radius_list)):
            self.add_module(f"irm{i - 1}", InvResMLP(
                radius_list[i], nsample_list[i], in_channel * 2, expansion,
                bias))

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
        inter = (group_points(fea2, idx) * w[..., None]).sum(dim=2)
        return self.mlp(torch.cat([fea1, inter], dim=-1))


class Encoder(nn.Module):
    """forward(points (B, N, 3+), valid (B, N)[, sweep]) -> (coor (B, S, 3),
    fea (B, S, out_channel), valid (B, S)). Config fields mirror the yaml
    `encoder:` tree."""

    def __init__(self, npoint=(4096, 1024, 256, 64, 16),
                 radius_list=((0.05, 0.1), (0.1, 0.2), (0.2, 0.4, 0.4),
                              (0.4, 0.8), (0.8, 1.6)),
                 nsample_list=((32, 32), (32, 32), (32, 32, 32), (32, 32),
                               (16, 16)),
                 in_channel: int = 3, out_channel: int = 128, width: int = 16,
                 expansion: int = 4, upsample_layers: int = 2,
                 bias: bool = True):
        super().__init__()
        self.npoint = tuple(npoint)
        self.nsample_list = tuple(tuple(n) for n in nsample_list)
        self.in_channel = in_channel
        self.upsample_layers = upsample_layers
        self.point_mlp0 = nn.Linear(in_channel, width)
        widths = [width]
        for i in range(len(self.npoint)):
            self.add_module(f"down{i}", Stage(
                self.npoint[i], radius_list[i], nsample_list[i], widths[-1],
                expansion, bias))
            widths.append(widths[-1] * 2)
        w = fea2_ch = widths[-1]
        for i in range(upsample_layers):
            up_out = max(out_channel, w // 2)
            fea1_ch = widths[len(self.npoint) - i - 1]
            self.add_module(f"up{i}", FeaturePropagation(
                fea1_ch + fea2_ch, (up_out, up_out), bias))
            fea2_ch = up_out
            w //= 2

    @classmethod
    def from_config(cls, args) -> "Encoder":
        e = args.encoder
        norm = str(e.get("norm", "LN")).lower()
        if norm != "ln":
            raise ValueError(f"only LayerNorm is supported (got {norm!r})")
        for s in e.sample:
            if not str(s["type"]).startswith("fps"):
                raise ValueError(f"sampler {s['type']!r} is not ported yet: "
                                 "use 'fps'")
        querier = str(e.get("querier", "hybrid")).lower()
        if querier not in ("hybrid", "hybrid-t3d"):
            raise ValueError(f"encoder.querier {querier!r} is not ported "
                             "yet: use 'hybrid'")
        return cls(npoint=tuple(e.npoint), radius_list=e.radius_list,
                   nsample_list=e.nsample_list, in_channel=e.in_channel,
                   out_channel=e.out_channel, width=e.width,
                   expansion=e["expansion"],
                   upsample_layers=e.upsample_layers,
                   bias=e.get("bias", True))

    def forward(self, points, valid, sweep=None):
        """sweep: optional (idx (B, N, Ks), dist2 (B, N, Ks)) candidate
        graph from device preprocessing (sweep_k > 0), in the units of
        `points`; it serves the FIRST stage's grouping without a fresh
        (npoint0, N) query."""
        coor = points[..., :3].float()
        fea = self.point_mlp0(points[..., :self.in_channel].float())
        levels = [(coor, fea, valid)]
        graph = None
        n = len(self.npoint)
        for i in range(n):
            # shared-graph width: the widest consumer among this level's
            # InvResMLP blocks and the next stage's SA
            own = max(self.nsample_list[i][1:], default=0)
            nxt = self.nsample_list[i + 1][0] if i + 1 < n else 0
            c, f, v, graph = getattr(self, f"down{i}")(
                *levels[-1], sweep=sweep if i == 0 else None,
                in_graph=graph, graph_k=max(own, nxt))
            levels.append((c, f, v))

        c, f, v = levels[-1]
        for i in range(self.upsample_layers):
            c1, f1, v1 = levels[n - i - 1]
            f = getattr(self, f"up{i}")(c1, c, f1, f, v)
            c, v = c1, v1
        return c, f, v
