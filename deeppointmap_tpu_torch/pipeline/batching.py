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

`BatchBuilder` is a stage's epoch of batches (the Trainer's serial path,
and the batch producer's, pipeline/producer.py): the epoch's
permutation, one S per global batch, the items and their assembly.
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from deeppointmap_tpu_torch.data.dataset import ready
from deeppointmap_tpu_torch.data.readers import Scan
from deeppointmap_tpu_torch.data.transforms import stages
from deeppointmap_tpu_torch.parallel.train_step import (LoopBatch,
                                                       RegistrationBatch)
from deeppointmap_tpu_torch.utils import se3 as se3m
from deeppointmap_tpu_torch.utils import timer

#: the batch's assembly from its items (utils/timer.py)
_ASSEMBLE = timer.span("train.assemble")

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


def split_size(S: int, cfg, rng: np.random.Generator) -> int:
    """S1, the size of the src map of a group of S frames
    (reference: model_pipeline.py:44-52)."""
    if S <= cfg.map_size_max:
        return 1 if (rng.random() < 0.5 or S == 2) else \
            int(rng.integers(1, S))
    return int(rng.integers(S - cfg.map_size_max, cfg.map_size_max + 1))


def build_registration_batch(frames: List[Scan], info: dict, cfg,
                             pad_to: int, rng: np.random.Generator
                             ) -> RegistrationBatch:
    """frames = num_map groups x S frames (SlamDatasets registration
    sample); split each group's S frames into src (S1) / dst (S2) maps
    and compute all relative poses (reference: model_pipeline.py:44-105)."""
    S1 = split_size(len(frames) // info["num_map"], cfg, rng)
    return assemble_registration(frames, info, S1, pad_to)


def assemble_registration(frames: List[Scan], info: dict, S1: int,
                          pad_to: int) -> RegistrationBatch:
    """build_registration_batch with the split drawn: draws nothing."""
    B = info["num_map"]
    S = len(frames) // B
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


class EpochPlan(NamedTuple):
    """What an epoch of batches depends on besides the generators: the
    stage, the curriculum's K (stage 1), the steps and the dataset items
    a global batch."""
    stage: int
    K: int
    n_steps: int
    items: int


class BatchBuilder:
    """A stage's epochs of host batches from a SlamDatasets, drawing from
    `rng` (the Trainer's: the permutation, the splits) and the dataset's
    generators, in the JAX Trainer's order: one S per global batch in
    stage 1, so that every rank's slice has the same shape."""

    def __init__(self, dataset, rng: np.random.Generator, cfg, pad_to: int):
        self.dataset, self.rng, self.cfg = dataset, rng, cfg
        self.pad_to = pad_to

    def state(self) -> tuple:
        """Where the build stands between two batches: the state of every
        generator it draws from and the attributes of the transform chain's
        stages (RandomRT pairs its calls); for `set_state`."""
        chain = list(stages(self.dataset.data_transforms))
        gens = {id(g): g for g in [self.rng, self.dataset.rng]
                + [getattr(s, "rng", None) for s in chain]
                if isinstance(g, np.random.Generator)}
        return ([(g, g.bit_generator.state) for g in gens.values()],
                [(s, dict(vars(s))) for s in chain if hasattr(s, "__dict__")])

    def set_state(self, state: tuple) -> None:
        gens, chain = state
        for g, st in gens:
            g.bit_generator.state = st
        for s, attrs in chain:
            vars(s).update(attrs)

    def epoch(self, plan: EpochPlan) -> Iterator:
        """The epoch's batches; draws nothing before the first is asked
        for."""
        ds = self.dataset
        if plan.stage == 1:
            ds.registration()
            ds.registration_cfg.K = plan.K
        else:
            ds.loop_detection()
        for idxs in self._epoch_indices(plan.n_steps, plan.items):
            yield self._registration(idxs) if plan.stage == 1 else \
                self._loop(idxs)

    def _epoch_indices(self, n_steps: int, bs: int):
        """Anchor indices per step: a fresh permutation of the dataset each
        epoch, topped up with random extras when the dataset is smaller
        than the steps need (trainer.py:88-95)."""
        perm = self.rng.permutation(len(self.dataset))
        need = n_steps * bs
        if need > len(perm):
            extra = self.rng.integers(0, len(self.dataset),
                                      size=need - len(perm))
            perm = np.concatenate([perm, extra])
        for i in range(n_steps):
            yield perm[i * bs:(i + 1) * bs]

    def _registration(self, idxs) -> RegistrationBatch:
        """Every item's draws and split first, in order; then the frames
        (futures where a loader builds them) and the assembly."""
        ds = self.dataset
        ds.forced_S = ds.sample_S()
        items = []
        try:
            for i in idxs:
                frames, info = ds[int(i)]
                items.append((frames, info, split_size(
                    len(frames) // info["num_map"], self.cfg.registration,
                    self.rng)))
        finally:
            ds.forced_S = None
        parts = []
        for frames, info, s1 in items:
            frames = [ready(f) for f in frames]
            with _ASSEMBLE:
                parts.append(assemble_registration(frames, info, s1,
                                                   self.pad_to))
        if len(parts) == 1:
            return parts[0]
        with _ASSEMBLE:
            return RegistrationBatch(*(np.concatenate(
                [getattr(p, f) for p in parts], axis=0)
                for f in RegistrationBatch._fields))

    def _loop(self, idxs) -> LoopBatch:
        pairs = [self.dataset[int(i)] for i in idxs]
        pairs = [(ready(a), ready(b)) for a, b in pairs]
        with _ASSEMBLE:
            return build_loop_batch(pairs, self.cfg.loop_detection.distance,
                                    self.pad_to)
