"""Host-side training batch construction (port of
deeppointmap_tpu/pipeline/batching.py; NumPy only).

Implements the data-dependent half of the reference's
DeepPointModelPipeline (reference: pipeline/modules/model_pipeline.py:
33-134, 199-298): random src/dst group split, ICP-refined relative poses
from per-scene refined_SE3.pkl with transitive bridge composition, GT
fallback, and fixed-shape padding. The device-side half (encode, token
transform, loss) is parallel/train_step.py. Every draw comes from the
caller's generator in the JAX package's order, so both packages build the
same batch from the same seed, byte for byte.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeppointmap_tpu_torch.data.readers import Scan
from deeppointmap_tpu_torch.parallel.train_step import (LoopBatch,
                                                       RegistrationBatch)
from deeppointmap_tpu_torch.utils import se3 as se3m

_SE3_CACHE: Dict[str, Optional[dict]] = {}


def load_refined_SE3(path: str) -> Optional[dict]:
    """Per-scene ICP-refined pairwise SE3 dict, cached
    (reference: model_pipeline.py:274-282)."""
    if path not in _SE3_CACHE:
        if path:
            try:
                with open(path, "rb") as f:
                    _SE3_CACHE[path] = pickle.load(f)
            except OSError:
                _SE3_CACHE[path] = None
        else:
            _SE3_CACHE[path] = None
    return _SE3_CACHE[path]


def get_SE3_from_dict(d: dict, s: int, t: int, bridge=None) -> np.ndarray:
    """Lookup (s -> t) with inversion and bridge composition
    (reference: model_pipeline.py:285-298). Raises KeyError if absent."""
    if s == t:
        return np.eye(4)
    if s < t:
        M = d.get((s, t))
        if M is not None:
            return np.linalg.inv(M)
    else:
        M = d.get((t, s))
        if M is not None:
            return np.asarray(M, np.float64)
    if bridge is None:
        raise KeyError((s, t))
    return get_SE3_from_dict(d, bridge, t, None) @ \
        get_SE3_from_dict(d, s, bridge, None)


def accurate_relative_SE3(src_idx: int, dst_idx: int,
                          src_scan: Scan, dst_scan: Scan,
                          refined: Optional[dict],
                          bridge: Optional[int] = None) -> np.ndarray:
    """SE3 mapping src frame coords -> dst frame coords: ICP-refined when
    available (corrected for augmentation calib), else GT relative pose
    (reference: model_pipeline.py:234-266)."""
    s_calib = np.asarray(src_scan.calib, np.float64)
    d_calib = np.asarray(dst_scan.calib, np.float64)
    if refined is not None:
        try:
            icp = get_SE3_from_dict(refined, src_idx, dst_idx, bridge)
            return d_calib @ icp @ np.linalg.inv(s_calib)
        except KeyError:
            pass
    R, T = se3m.global_to_relative(dst_scan.rotation, dst_scan.translation,
                                   src_scan.rotation, src_scan.translation)
    return se3m.se3(R, T)


def pad_points(xyz: np.ndarray, pad_to: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    n = min(xyz.shape[0], pad_to)
    pts = np.zeros((pad_to, 3), np.float32)
    val = np.zeros((pad_to,), bool)
    pts[:n] = xyz[:n]
    val[:n] = True
    return pts, val


def build_registration_batch(frames: List[Scan], info: dict, cfg,
                             pad_to: int, rng: np.random.Generator
                             ) -> RegistrationBatch:
    """frames = num_map groups x S frames (SlamDatasets registration
    sample); split each group's S frames into src (S1) / dst (S2) maps
    and compute all relative poses (reference: model_pipeline.py:44-105)."""
    B = info["num_map"]
    S = len(frames) // B
    map_size_max = cfg.map_size_max

    if S <= map_size_max:
        S1 = 1 if (rng.random() < 0.5 or S == 2) else \
            int(rng.integers(1, S))
    else:
        S1 = int(rng.integers(S - map_size_max, map_size_max + 1))

    dsf = info["dsf_index"]           # [(dataset, scene, frame)] * (B*S)
    refined_files = info["refined_SE3_file"]  # len B

    points = np.zeros((B, S, pad_to, 3), np.float32)
    valid = np.zeros((B, S, pad_to), bool)
    group_SE3 = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    group_id = np.zeros((B, S), np.int32)
    gt_R = np.zeros((B, 3, 3), np.float32)
    gt_t = np.zeros((B, 3), np.float32)

    for b in range(B):
        grp = frames[b * S:(b + 1) * S]
        idxs = [dsf[b * S + i][2] for i in range(S)]
        refined = load_refined_SE3(refined_files[b])
        src_anchor, dst_anchor = 0, S1
        for i in range(S):
            points[b, i], valid[b, i] = pad_points(grp[i].xyz, pad_to)
            group_id[b, i] = 0 if i < S1 else 1
            anchor = src_anchor if i < S1 else dst_anchor
            if i != anchor:
                group_SE3[b, i] = accurate_relative_SE3(
                    idxs[i], idxs[anchor], grp[i], grp[anchor], refined,
                    bridge=idxs[src_anchor] if i >= S1 else None)
        gt = accurate_relative_SE3(idxs[src_anchor], idxs[dst_anchor],
                                   grp[src_anchor], grp[dst_anchor], refined)
        gt_R[b] = gt[:3, :3]
        gt_t[b] = gt[:3, 3]

    return RegistrationBatch(points=points, valid=valid,
                             group_SE3=group_SE3, group_id=group_id,
                             gt_R=gt_R, gt_t=gt_t)


def build_loop_batch(pairs: List[Tuple[Scan, Scan]], distance: float,
                     pad_to: int) -> LoopBatch:
    """Frame pairs + binary overlap labels from GT translation distance
    (reference: model_pipeline.py:136-158)."""
    B = len(pairs)
    pa = np.zeros((B, pad_to, 3), np.float32)
    va = np.zeros((B, pad_to), bool)
    pb = np.zeros((B, pad_to, 3), np.float32)
    vb = np.zeros((B, pad_to), bool)
    label = np.zeros((B,), np.float32)
    for i, (a, b) in enumerate(pairs):
        pa[i], va[i] = pad_points(a.xyz, pad_to)
        pb[i], vb[i] = pad_points(b.xyz, pad_to)
        d = np.linalg.norm(a.translation - b.translation)
        label[i] = 1.0 if d <= distance else 0.0
    return LoopBatch(points_a=pa, valid_a=va, points_b=pb, valid_b=vb,
                     label=label)
