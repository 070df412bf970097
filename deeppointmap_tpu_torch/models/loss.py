"""Registration training loss, fixed-shape and mask-aware (port of
deeppointmap_tpu/models/loss.py).

L = lambda_p * L_pairing + lambda_c * L_coarse + lambda_o * L_offset,
taken symmetrically src -> dst and dst -> src (reference: network/
loss.py:10-179). Dynamic boolean indexing becomes masked means; neutral
(near but not nearest) logits are pushed to -1e8, as the reference does.

Data parallelism: every masked mean divides by a count, and the mahalanobis
offset whitens by a covariance, taken over the WHOLE batch in the JAX
package's step. `reduce_sum` sums a detached tensor over the ranks of the
process group (the identity in one process), so each rank divides its own
sum by the global count: a value returned here is this rank's share, the
global value is the sum of the shares over the ranks, and so is its
gradient.

The pairing logits and the top-1 similarity take the `tpu.bf16` rule
(utils/precision.py) through `policy`; the mahalanobis covariance and
quadratic form, over x, y, z, stay float32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.nn import functional as F

from deeppointmap_tpu_torch.utils import precision

ReduceSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _local(x: torch.Tensor) -> torch.Tensor:
    return x


class LossConfig(NamedTuple):
    tau: float = 0.1
    offset_value: str = "euclidean"
    eps_positive: float = 1.0
    eps_offset: float = 2.0
    lambda_p: float = 1.0
    lambda_c: float = 1.0
    lambda_o: float = 1.0

    @classmethod
    def from_args(cls, args) -> "LossConfig":
        c = args.loss
        return cls(tau=c.tau, offset_value=c.get("offset_value", "euclidean"),
                   eps_positive=c.get("eps_positive", 1.0),
                   eps_offset=c.eps_offset,
                   lambda_p=c.get("lambda_p", 1.0),
                   lambda_c=c.get("lambda_c", 1.0),
                   lambda_o=c.get("lambda_o", 1.0))


def make_pairs(src_global, dst_global, src_valid, dst_valid,
               eps_positive: float):
    """GT pairs: each src point's nearest valid dst point within eps, and
    the neutral mask of near-but-not-nearest pairs (reference:
    loss.py:92-111). -> (corr_ids (B, S) int64, corr_mask (B, S) bool,
    neutral (B, S, D) bool). Ties go to the first index, as jnp.argmin."""
    d2 = ((src_global[:, :, None, :] - dst_global[:, None, :, :]) ** 2
          ).sum(-1)                                            # (B, S, D)
    d2 = torch.where(dst_valid[:, None, :], d2, torch.full_like(d2, 1e18))
    min_d2, corr_ids = d2.min(dim=-1)
    eps2 = float(eps_positive ** 2)   # compared in float32, as in JAX
    neutral = d2 <= eps2
    onehot = F.one_hot(corr_ids, d2.shape[-1]).bool()
    neutral = neutral & ~onehot
    corr_mask = (min_d2 <= eps2) & src_valid
    return corr_ids, corr_mask, neutral


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _count(mask, reduce_sum) -> torch.Tensor:
    """max(number of True entries over every rank, 1)."""
    return torch.clamp(reduce_sum(mask.float().sum()), min=1.0)


def _cosine(src_fea, dst_fea, policy: str):
    """(B, S, C) x (B, D, C) -> cosine similarities (B, S, D)."""
    return precision.bmm(_normalize(src_fea),
                         _normalize(dst_fea).transpose(1, 2), policy)


def pairing_loss(src_fea, dst_fea, src_valid, corr_ids, corr_mask, neutral,
                 tau: float, reduce_sum: ReduceSum = None,
                 policy: str = precision.UNCHANGED):
    """Masked InfoNCE over cosine-similarity logits (reference:
    loss.py:113-142)."""
    reduce_sum = reduce_sum or _local
    logits = _cosine(src_fea, dst_fea, policy)
    logits = torch.where(neutral, torch.full_like(logits, -1e8), logits)
    logprobs = torch.log_softmax(logits / tau, dim=-1)
    picked = torch.gather(logprobs, -1, corr_ids[..., None])[..., 0]
    use = corr_mask & src_valid
    total = torch.where(use, picked, torch.zeros_like(picked)).sum()
    return -total / _count(use, reduce_sum)


def offset_loss(offset_res, pair_valid, offset_value: str = "euclidean",
                reduce_sum: ReduceSum = None):
    """Mean offset residual magnitude over the valid pairs (reference:
    loss.py:144-161). The mahalanobis variant whitens by the covariance of
    the detached residuals; the reference's try-inverse-else-identity
    becomes a select on a scale-relative gate, |det| > 1e-6 (tr / 3)^3,
    after inverting a matrix that is always invertible."""
    reduce_sum = reduce_sum or _local
    if offset_value == "manhattan":
        err = offset_res.abs().sum(-1)
    elif offset_value == "euclidean":
        err = torch.linalg.vector_norm(offset_res, dim=-1)
    elif offset_value == "mahalanobis":
        res = offset_res.detach().reshape(-1, 3)
        w = pair_valid.reshape(-1).to(res.dtype)
        n = torch.clamp(reduce_sum(w.sum()), min=1.0)
        mean = reduce_sum((res * w[:, None]).sum(0)) / n
        cen = (res - mean) * w[:, None]
        cov = reduce_sum(cen.T @ cen) / torch.clamp(n - 1.0, min=1.0)
        tr = torch.trace(cov)
        ok = torch.abs(torch.linalg.det(cov)) > \
            1e-6 * torch.clamp(tr / 3.0, min=1e-30) ** 3
        eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
        cov_inv = torch.where(ok, torch.linalg.inv(torch.where(ok, cov, eye)),
                              eye)
        quad = torch.einsum("...j,jk,...k->...", offset_res, cov_inv,
                            offset_res)
        err = torch.sqrt(torch.clamp(quad, min=1e-12))
    else:
        raise ValueError(f"unsupported offset_value: {offset_value!r}")
    total = torch.where(pair_valid, err, torch.zeros_like(err)).sum()
    return total / _count(pair_valid, reduce_sum)


def top1_pairing_acc(src_fea, dst_fea, src_valid, corr_ids, corr_mask,
                     reduce_sum: ReduceSum = None,
                     policy: str = precision.UNCHANGED):
    """Top-1 pairing accuracy (reference: loss.py:163-179); a metric, so
    it carries no gradient."""
    reduce_sum = reduce_sum or _local
    with torch.no_grad():
        sim = _cosine(src_fea, dst_fea, policy)
        pred = sim.argmax(dim=-1)
        use = corr_mask & src_valid
        hit = (pred == corr_ids) & use
        return hit.float().sum() / _count(use, reduce_sum)


def registration_loss(cfg: LossConfig, src_global, dst_global, src_valid,
                      dst_valid, dec_out: Dict,
                      reduce_sum: ReduceSum = None,
                      policy: str = precision.UNCHANGED) -> Dict:
    """The full symmetric loss. `src_global` / `dst_global` are the
    descriptors' GT-frame coordinates (B, S, 3) / (B, D, 3); `dec_out` is
    Decoder.train_forward's dict; `policy` the decoder's matmul policy."""
    ids_s, mask_s, neu_s = make_pairs(src_global, dst_global,
                                      src_valid, dst_valid, cfg.eps_positive)
    ids_d, mask_d, neu_d = make_pairs(dst_global, src_global,
                                      dst_valid, src_valid, cfg.eps_positive)
    no_neutral_s = torch.zeros_like(neu_s)
    no_neutral_d = torch.zeros_like(neu_d)

    sp, dp = dec_out["src_pairing_fea"], dec_out["dst_pairing_fea"]
    sc, dc = dec_out["src_coarse_fea"], dec_out["dst_coarse_fea"]
    pair = lambda a, b, valid, ids, mask, neu: pairing_loss(
        a, b, valid, ids, mask, neu, cfg.tau, reduce_sum, policy)
    l_pair = (pair(sp, dp, src_valid, ids_s, mask_s, no_neutral_s)
              + pair(dp, sp, dst_valid, ids_d, mask_d, no_neutral_d)) / 2
    l_coarse = (pair(sc, dc, src_valid, ids_s, mask_s, neu_s)
                + pair(dc, sc, dst_valid, ids_d, mask_d, neu_d)) / 2
    l_off = (offset_loss(dec_out["src_offset_res"], dec_out["pair_valid"],
                         cfg.offset_value, reduce_sum)
             + offset_loss(dec_out["dst_offset_res"], dec_out["pair_valid"],
                           cfg.offset_value, reduce_sum)) / 2
    acc = (top1_pairing_acc(sp, dp, src_valid, ids_s, mask_s, reduce_sum,
                            policy)
           + top1_pairing_acc(dp, sp, dst_valid, ids_d, mask_d, reduce_sum,
                              policy)) / 2

    loss = cfg.lambda_p * l_pair + cfg.lambda_c * l_coarse \
        + cfg.lambda_o * l_off
    return {"loss": loss, "loss_pairing": l_pair, "loss_coarse": l_coarse,
            "loss_offset": l_off, "top1_acc": acc}
