"""On-device preprocessing for the inference hot path (port of
deeppointmap_tpu/data/preprocess.py).

The reference chain DistanceSample -> OutlierFilter -> LowPassFilter ->
CoordinatesNormalization (reference: configs/infer/
DeepPointMap_B_Main_SemanticKITTI.yaml:21-29) as validity-mask updates
over fixed-size padded scans: points are never removed. Only the voxel
downsample runs on the host (data/voxel.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeppointmap_tpu_torch.ops.normals import (dot3, filter_sweep,
                                                normals_from_moments)


class PreprocessConfig(NamedTuple):
    """Stages absent from the yaml chain are disabled."""

    use_distance: bool = True
    min_dis: float = 1.0
    max_dis: float = 60.0
    use_outlier: bool = True
    outlier_neighbors: int = 10
    outlier_std: float = 3.0
    use_lowpass: bool = True
    normals_radius: float = 0.5
    normals_num: int = 16
    lowpass_std: float = 2.0
    lowpass_flux: int = 4
    norm_ratio: float = 60.0
    #: when > 0, widen the shared sweep's top-k to this many candidates and
    #: return them ((B, P, sweep_k) idx + normalized dist2), so that the
    #: encoder's stage-1 grouping is served from the sweep instead of a
    #: fresh (npoint0, P) query (models/encoder._group_from_sweep). The
    #: candidates are ranked under the post-crop validity; later filter
    #: drops are re-masked when the groups are picked.
    sweep_k: int = 0

    @classmethod
    def from_transforms(cls, transforms: dict,
                        sweep_k: int = 0) -> "PreprocessConfig":
        """Build from the yaml `transforms:` tree (the keys the host chain
        uses)."""
        t = dict(transforms)
        kw = {"use_distance": "DistanceSample" in t,
              "use_outlier": "OutlierFilter" in t,
              "use_lowpass": "LowPassFilter" in t}
        if kw["use_distance"]:
            kw["min_dis"] = t["DistanceSample"]["min_dis"]
            kw["max_dis"] = t["DistanceSample"]["max_dis"]
        if kw["use_outlier"]:
            kw["outlier_neighbors"] = t["OutlierFilter"]["nb_neighbors"]
            kw["outlier_std"] = t["OutlierFilter"]["std_ratio"]
        if kw["use_lowpass"]:
            lp = t["LowPassFilter"]
            if float(lp["normals_radius"]) <= 0:
                raise ValueError("LowPassFilter.normals_radius must be "
                                 f"> 0 (got {lp['normals_radius']})")
            kw["normals_radius"] = lp["normals_radius"]
            kw["normals_num"] = lp["normals_num"]
            kw["lowpass_std"] = lp["filter_std"]
            kw["lowpass_flux"] = lp["flux"]
        t_norm = t.get("CoordinatesNormalization")
        kw["norm_ratio"] = t_norm["ratio"] if t_norm else 1.0
        kw["sweep_k"] = sweep_k
        return cls(**kw)


def _masked_mean_std(x, mask):
    """Per scan: x (B, P), mask (B, P) -> mean (B, 1), std (B, 1), in
    float64."""
    x = x.double()
    m = mask.double()
    n = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    mean = (x * m).sum(-1, keepdim=True) / n
    var = (((x - mean) ** 2) * m).sum(-1, keepdim=True) / n
    return mean, torch.sqrt(var)


def preprocess(points, valid, cfg: PreprocessConfig):
    """(B, P, 3) raw-meter points + validity (B, P) -> (normalized points,
    validity), and with cfg.sweep_k > 0 also the sweep's candidate graph
    (idx (B, P, sweep_k) int64, dist2 (B, P, sweep_k) in normalized units,
    invalid candidates at 1e9). Mask-update equivalents of (reference file:line): distance
    crop transforms.py:387-397, statistical outlier removal
    transforms.py:230-253, normal-coherence low-pass transforms.py:256-297,
    coordinate normalization transforms.py:400-407.

    One (P, P) sweep (k = max(outlier_k + 1, coherence_k + 1)) feeds the
    outlier filter, the coherence neighbourhoods and the radius moments
    for the normals; the approximations this shares with the JAX package
    (normals on the pre-outlier cloud, dropped neighbours masked rather
    than re-queried) are described there.

    Square roots, divisions and statistics run in float64: PyTorch's
    float32 sqrt and division on the GPU are not correctly rounded, and the
    CPU and the GPU must keep the same survivors (one survivor changes
    every later FPS pick). A float32 quotient taken in float64 and rounded
    once is the correctly rounded one, so the normalized points are those
    of the JAX package."""
    pts = points.float()
    if cfg.use_distance:
        dist = torch.sqrt(dot3(pts, pts).double())
        valid = valid & (dist >= cfg.min_dis) & (dist <= cfg.max_dis)

    if cfg.use_outlier or cfg.use_lowpass or cfg.sweep_k > 0:
        k_shared = max((cfg.normals_num + 1) if cfg.use_lowpass else 0,
                       (cfg.outlier_neighbors + 1) if cfg.use_outlier else 0,
                       cfg.sweep_k)
        out = filter_sweep(pts, valid, k_shared,
                           cfg.normals_radius if cfg.use_lowpass else 0.0)
        nb_idx, nb_d2 = out[:2]

    if cfg.use_outlier:
        d2 = nb_d2[..., 1:cfg.outlier_neighbors + 1].double()
        mean_d = torch.sqrt(torch.clamp(d2, min=0.0)).mean(-1)
        mu, sd = _masked_mean_std(mean_d, valid)
        valid = valid & (mean_d <= mu + cfg.outlier_std * sd)

    if cfg.use_lowpass:
        normals = normals_from_moments(pts, *out[2:])
        idx = nb_idx[..., 1:cfg.normals_num + 1]
        b = torch.arange(pts.shape[0], device=pts.device)[:, None, None]
        sim = torch.abs(dot3(normals[b, idx], normals[..., None, :]))
        sim = torch.where(valid[b, idx], sim, torch.zeros_like(sim))
        top = torch.topk(sim, cfg.lowpass_flux, dim=-1).values
        s = top[..., 0]
        for i in range(1, cfg.lowpass_flux):
            s = s + top[..., i]
        mu_s, sd_s = _masked_mean_std(s, valid)
        valid = valid & (s > mu_s - cfg.lowpass_std * sd_s)

    pts_n = (pts.double() / cfg.norm_ratio).float()
    if cfg.sweep_k > 0:
        # a uniform scale keeps the ranking, so dist2 rescales by ratio^-2
        # (in float64, rounded once); the 1e9 sentinel is pinned again so
        # that it stays a sentinel in normalized units
        d2 = nb_d2[..., :cfg.sweep_k]
        scaled = (d2.double() / (cfg.norm_ratio * cfg.norm_ratio)).float()
        d2 = torch.where(d2 >= 1e8, torch.full_like(d2, 1e9), scaled)
        return pts_n, valid, (nb_idx[..., :cfg.sweep_k], d2)
    return pts_n, valid
