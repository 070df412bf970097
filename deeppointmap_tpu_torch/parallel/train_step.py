"""Training steps: registration (stage 1) and loop detection (stage 2)
(port of deeppointmap_tpu/parallel/train_step.py).

The reference builds src / dst "maps" by splitting S frames into two
groups re-centred with GT / ICP-refined relative poses (reference:
pipeline/modules/model_pipeline.py:33-181). As in the JAX package the
work is split: the host (pipeline/batching.py) does everything random and
data-dependent; the step encodes all B*S frames, moves the descriptor
tokens rigidly into their group frames, concatenates the groups into map
descriptor sets, runs Decoder.train_forward and the loss, and updates.

The encoder launches the CUDA kernels K1 (FPS) and K2 (kNN) inside the
graph that autograd records. Their outputs (indices, and distances of
coordinates that carry no gradient) need no backward. With `remat` the
encoder runs under torch.utils.checkpoint, so its activations are
recomputed in the backward pass, and K1 and K2 launch a second time there.

Data parallelism (parallel/ddp.py): each rank steps on its slice of the
global batch; the losses divide by counts summed over the ranks, the
gradients are summed over the ranks before the update, and the metrics
are summed once a step (every returned value is the global one).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeppointmap_tpu_torch.models.loss import LossConfig, registration_loss
from deeppointmap_tpu_torch.parallel.ddp import DataParallel
from deeppointmap_tpu_torch.utils import timer

#: the step's one host sync, the metrics' fetch (utils/timer.py)
_SYNC = timer.span("train.sync")


class RegistrationBatch(NamedTuple):
    """One stage-1 batch. S = S1 + S2 frames per element.

    points     (B, S, P, 3) normalized coordinates, frame-local
    valid      (B, S, P)
    group_SE3  (B, S, 4, 4) frame -> its group's anchor frame (meters)
    group_id   (B, S) int32: 0 = src map, 1 = dst map
    gt_R       (B, 3, 3) src map -> dst map rotation (meters)
    gt_t       (B, 3)
    """
    points: object
    valid: object
    group_SE3: object
    group_id: object
    gt_R: object
    gt_t: object


class LoopBatch(NamedTuple):
    """One stage-2 batch: frame pairs and 0/1 overlap labels
    (reference: model_pipeline.py:136-181)."""
    points_a: object   # (B, P, 3)
    valid_a: object
    points_b: object
    valid_b: object
    label: object      # (B,) float 0/1: distance <= d


def to_device(batch: NamedTuple, device) -> NamedTuple:
    """A host batch (NumPy fields) -> the same NamedTuple of tensors."""
    return type(batch)(*(torch.as_tensor(np.asarray(x)).to(device)
                         for x in batch))


def _encode_frames(encoder, points, valid, coor_scale: float,
                   remat: bool = False):
    """(B, S, P, 3) -> descriptors (B, S, K, C+3), xyz in meters, and
    their validity (B, S, K). remat: recompute the encoder's activations
    in the backward pass instead of keeping them (B*S frames at every
    stage) across the decoder and the loss."""
    b, s, p, _ = points.shape
    flat_pts = points.reshape(b * s, p, 3)
    flat_valid = valid.reshape(b * s, p)
    if remat:
        coor, fea, out_valid = checkpoint(encoder, flat_pts, flat_valid,
                                          use_reentrant=False)
    else:
        coor, fea, out_valid = encoder(flat_pts, flat_valid)
    k = coor.shape[1]
    desc = torch.cat([fea, coor * coor_scale], dim=-1)
    return desc.reshape(b, s, k, -1), out_valid.reshape(b, s, k)


def _build_maps(desc, dvalid, group_SE3, group_id):
    """Move the tokens into their group frames and split them into the src
    and dst map sets (reference: model_pipeline.py:52-105), fixed-shape:
    both maps have S*K token slots, the other group's tokens invalid."""
    b, s, k, c = desc.shape
    R = group_SE3[..., :3, :3]
    t = group_SE3[..., :3, 3]
    moved = torch.einsum("bsij,bskj->bski", R, desc[..., -3:]) \
        + t[:, :, None, :]
    desc = torch.cat([desc[..., :-3], moved], dim=-1)
    desc_flat = desc.reshape(b, s * k, c)
    valid_flat = dvalid.reshape(b, s * k)
    gid = torch.repeat_interleave(group_id, k, dim=1)
    return desc_flat, valid_flat & (gid == 0), valid_flat & (gid == 1)


def registration_metrics(encoder, decoder, loss_cfg: LossConfig,
                         batch: RegistrationBatch, coor_scale: float = 60.0,
                         max_pairs: int = 1024, remat: bool = False,
                         reduce_sum=None) -> Dict[str, torch.Tensor]:
    """Stage 1's loss and metrics on a device batch (loss parity:
    network/loss.py:28-90); with `reduce_sum`, this rank's shares."""
    desc, dvalid = _encode_frames(encoder, batch.points, batch.valid,
                                  coor_scale, remat=remat)
    tokens, src_valid, dst_valid = _build_maps(desc, dvalid, batch.group_SE3,
                                               batch.group_id)
    out = decoder.train_forward(tokens, tokens, src_valid, dst_valid,
                                batch.gt_R, batch.gt_t, max_pairs)
    # GT-frame coordinates for the pairs: src tokens moved by the GT pose
    xyz = tokens[..., -3:]
    src_global = torch.einsum("bij,bnj->bni", batch.gt_R, xyz) \
        + batch.gt_t[:, None, :]
    return registration_loss(loss_cfg, src_global, xyz, src_valid, dst_valid,
                             out, reduce_sum, decoder.matmul_policy)


def loop_metrics(encoder, decoder, batch: LoopBatch, coor_scale: float = 60.0,
                 reduce_sum=None) -> Dict[str, torch.Tensor]:
    """Stage 2: BCE of the overlap head, clipped at 1e-7, with accuracy and
    the tp / fp / fn counts (reference: model_pipeline.py:136-181). The
    encoder is frozen in stage 2 and runs without grad."""
    reduce_sum = reduce_sum or (lambda x: x.detach())
    with torch.no_grad():
        ca, fa, va = encoder(batch.points_a, batch.valid_a)
        cb, fb, vb = encoder(batch.points_b, batch.valid_b)
    da = torch.cat([fa, ca * coor_scale], dim=-1)
    db = torch.cat([fb, cb * coor_scale], dim=-1)
    prob = decoder.loop_detection(da, db, va, vb)
    eps = 1e-7
    p = torch.clamp(prob, eps, 1 - eps)
    y = batch.label
    n = reduce_sum(torch.tensor(float(y.shape[0]), device=y.device))
    bce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).sum() / n
    with torch.no_grad():
        pred, pos = p > 0.5, y > 0.5
        acc = (pred == pos).float().sum() / n
        tp = (pred & pos).float().sum()
        fp = (pred & ~pos).float().sum()
        fn = (~pred & pos).float().sum()
    return {"loss": bce, "acc": acc, "tp": tp, "fp": fp, "fn": fn}


def loop_summary(m: Dict[str, float]) -> Dict[str, float]:
    """Stage 2's reported scalars from the summed counts: precision,
    recall and the false-positive count (model_pipeline.py:175-180)."""
    tp, fp, fn = m["tp"], m["fp"], m["fn"]
    return {"loss": m["loss"], "acc": m["acc"],
            "precision": tp / max(tp + fp, 1.0),
            "recall": tp / max(tp + fn, 1.0), "fp": fp}


class TrainStep:
    """One optimizer step: zero the gradients, the loss on this rank's
    slice, backward, the gradients summed over the ranks, the update and
    the schedule's step. Trainable parameters are the optimizer's; one
    that got no gradient gets zeros, so that it is still updated (weight
    decay, momentum) as optax updates every unmasked leaf. -> the metrics
    as Python floats, summed over the ranks (one host sync a step)."""

    def __init__(self, metrics_fn: Callable, optimizer, scheduler=None,
                 ddp: Optional[DataParallel] = None,
                 summary: Optional[Callable] = None):
        self.metrics_fn = metrics_fn
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.ddp = ddp or DataParallel()
        self.summary = summary
        self.params = [p for g in optimizer.param_groups for p in g["params"]]

    def __call__(self, batch) -> Dict[str, float]:
        self.optimizer.zero_grad(set_to_none=True)
        metrics = self.metrics_fn(batch, self.ddp.reduce_sum)
        metrics["loss"].backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.ddp.sum_grads(self.params)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        names = list(metrics)
        with _SYNC:
            values = self.ddp.reduce_sum(torch.stack(
                [metrics[k].detach().float() for k in names])).tolist()
        out = dict(zip(names, values))
        return self.summary(out) if self.summary else out


def make_registration_train_step(
        encoder, decoder, loss_cfg: LossConfig, optimizer, scheduler=None,
        coor_scale: float = 60.0, max_pairs: int = 1024, remat: bool = False,
        ddp: Optional[DataParallel] = None) -> TrainStep:
    """The stage-1 step: step(device RegistrationBatch) -> metrics."""
    return TrainStep(
        lambda batch, reduce_sum: registration_metrics(
            encoder, decoder, loss_cfg, batch, coor_scale, max_pairs, remat,
            reduce_sum), optimizer, scheduler, ddp)


def make_loop_train_step(encoder, decoder, optimizer, scheduler=None,
                         coor_scale: float = 60.0,
                         ddp: Optional[DataParallel] = None) -> TrainStep:
    """The stage-2 step: step(device LoopBatch) -> metrics; the optimizer
    holds the loop head only (loop_param_mask)."""
    return TrainStep(
        lambda batch, reduce_sum: loop_metrics(encoder, decoder, batch,
                                               coor_scale, reduce_sum),
        optimizer, scheduler, ddp, summary=loop_summary)


def loop_param_mask(part: str, name: str) -> bool:
    """True = trainable in stage 2: the loop head only (the reference
    freezes every parameter whose name lacks 'loop',
    model_pipeline.py:185-197). `part` is "encoder" or "decoder", `name`
    the parameter's name in that module."""
    return part == "decoder" and name.startswith("loop")
