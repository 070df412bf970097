"""The plain reference of DeepPointMap's registration (stage-1) training
step, in plain PyTorch over a Flax-layout parameter tree: the encoder on
every frame, the frames' tokens moved into their map's frame, the
matcher's training forward (correlation, similarity and coarse heads, the
ground-truth proximity pairs, offsets both ways), the symmetric loss
(InfoNCE pairing, coarse pairing with neutral pairs masked, euclidean
offset residuals) and an AdamW step with the cosine schedule. It follows
the DeepPointMap training objective (upstream network/loss.py) and
imports nothing of the program.

Products take `Ref`'s precision in the forward pass and, through
`RoundedMM`, in the backward pass too (both operands of every gradient
product rounded), as the tpu.bf16 rule rounds the gradients' products.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from benchmark.reference.model import Ref, _round, gather


class RoundedMM(torch.autograd.Function):
    """a @ b with both operands rounded to `prec`, forward and backward."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return _round(a, prec) @ _round(b, prec)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = lambda x: _round(x, ctx.prec)
        ga = r(g) @ r(b).transpose(-1, -2)
        gb = r(a).transpose(-1, -2) @ r(g)
        # broadcast batch dims back to the operands' shapes
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        if gb.shape != b.shape:
            gb = gb.sum_to_size(b.shape)
        if ga.shape != a.shape:
            ga = ga.sum_to_size(a.shape)
        return ga, gb, None


class TrainRef(Ref):
    """Ref with differentiable rounded products."""

    def mm(self, a, b):
        if self.prec == "f32":
            return a @ b
        return RoundedMM.apply(a, b, self.prec)

    # ----------------------------------------------------- forward
    def train_forward(self, tokens, src_valid, dst_valid, gt_R, gt_t,
                      max_pairs: int, eps_offset: float):
        P = self.P["decoder"]
        coarse = lambda x: self.head(x[..., :-3], P["coarse_pairing_head"])
        src_coarse, dst_coarse = coarse(tokens), coarse(tokens)
        sf, df = self.correlate(tokens, tokens, src_valid, dst_valid)
        xyz = tokens[..., -3:]
        sp = self.head(sf, P["similarity_head"])
        dp = self.head(df, P["similarity_head"])
        src_gt = torch.einsum("bij,bnj->bni", gt_R, xyz) + gt_t[:, None]
        d2 = ((src_gt[:, :, None] - xyz[:, None]) ** 2).sum(-1)
        near = (d2 <= float(eps_offset ** 2)) & src_valid[:, :, None] \
            & dst_valid[:, None, :]
        n = near.shape[2]
        vals, flat = torch.sort(near.reshape(near.shape[0], -1).float(),
                                dim=-1, descending=True, stable=True)
        flat, pair_valid = flat[:, :max_pairs], vals[:, :max_pairs] > 0.5
        si, di = flat // n, flat % n
        s_f, d_f = gather(sf, si), gather(df, di)
        s_gt, d_gt = gather(src_gt, si), gather(xyz, di)
        o_sd = self.offset(torch.cat([s_f, d_f], -1))
        o_ds = self.offset(torch.cat([d_f, s_f], -1))
        gap = d_gt - s_gt
        return dict(sp=sp, dp=dp, sc=src_coarse, dc=dst_coarse,
                    src_res=o_sd - torch.einsum("bji,bpj->bpi", gt_R, gap),
                    dst_res=o_ds + gap, pair_valid=pair_valid)

    def step_loss(self, batch, coor_scale: float, loss: dict,
                  max_pairs: int):
        """The stage-1 loss of one batch (dict of tensors: points (B, S,
        P, 3), valid, group_SE3, group_id, gt_R, gt_t)."""
        b, s, p, _ = batch["points"].shape
        coor, fea, v = self.encode(batch["points"].reshape(b * s, p, 3),
                                   batch["valid"].reshape(b * s, p))
        k = coor.shape[1]
        desc = torch.cat([fea, coor * coor_scale], -1).reshape(b, s, k, -1)
        dv = v.reshape(b, s, k)
        R = batch["group_SE3"][..., :3, :3]
        t = batch["group_SE3"][..., :3, 3]
        moved = torch.einsum("bsij,bskj->bski", R, desc[..., -3:]) \
            + t[:, :, None]
        tokens = torch.cat([desc[..., :-3], moved], -1).reshape(b, s * k, -1)
        valid = dv.reshape(b, s * k)
        gid = torch.repeat_interleave(batch["group_id"].long(), k, dim=1)
        sv, dvv = valid & (gid == 0), valid & (gid == 1)
        out = self.train_forward(tokens, sv, dvv, batch["gt_R"],
                                 batch["gt_t"], max_pairs,
                                 float(loss["eps_offset"]))
        xyz = tokens[..., -3:]
        src_g = torch.einsum("bij,bnj->bni", batch["gt_R"], xyz) \
            + batch["gt_t"][:, None]
        return symmetric_loss(self, src_g, xyz, sv, dvv, out, loss)


def _pairs(src_g, dst_g, src_valid, dst_valid, eps: float):
    d2 = ((src_g[:, :, None] - dst_g[:, None]) ** 2).sum(-1)
    d2 = torch.where(dst_valid[:, None], d2, torch.full_like(d2, 1e18))
    mn, ids = d2.min(-1)
    neutral = (d2 <= float(eps ** 2)) & ~F.one_hot(ids, d2.shape[-1]).bool()
    return ids, (mn <= float(eps ** 2)) & src_valid, neutral


def _pairing(ref, a, b, valid, ids, mask, neutral, tau):
    na = a / torch.clamp(a.norm(dim=-1, keepdim=True), min=1e-12)
    nb = b / torch.clamp(b.norm(dim=-1, keepdim=True), min=1e-12)
    logits = ref.mm(na, nb.transpose(1, 2))
    if neutral is not None:
        logits = torch.where(neutral, torch.full_like(logits, -1e8), logits)
    lp = torch.log_softmax(logits / tau, -1)
    picked = torch.gather(lp, -1, ids[..., None])[..., 0]
    use = mask & valid
    return -torch.where(use, picked, torch.zeros_like(picked)).sum() \
        / torch.clamp(use.float().sum(), min=1.0)


def _offset(res, pair_valid):
    err = torch.linalg.vector_norm(res, dim=-1)
    return torch.where(pair_valid, err, torch.zeros_like(err)).sum() \
        / torch.clamp(pair_valid.float().sum(), min=1.0)


def symmetric_loss(ref, src_g, dst_g, sv, dv, out, loss: dict):
    if loss.get("offset_value", "euclidean") != "euclidean":
        raise ValueError("the reference holds the euclidean offset loss")
    tau, eps = float(loss["tau"]), float(loss.get("eps_positive", 1.0))
    ids_s, m_s, neu_s = _pairs(src_g, dst_g, sv, dv, eps)
    ids_d, m_d, neu_d = _pairs(dst_g, src_g, dv, sv, eps)
    l_pair = (_pairing(ref, out["sp"], out["dp"], sv, ids_s, m_s, None, tau)
              + _pairing(ref, out["dp"], out["sp"], dv, ids_d, m_d, None,
                         tau)) / 2
    l_coarse = (_pairing(ref, out["sc"], out["dc"], sv, ids_s, m_s, neu_s,
                         tau)
                + _pairing(ref, out["dc"], out["sc"], dv, ids_d, m_d, neu_d,
                           tau)) / 2
    l_off = (_offset(out["src_res"], out["pair_valid"])
             + _offset(out["dst_res"], out["pair_valid"])) / 2
    return float(loss.get("lambda_p", 1.0)) * l_pair \
        + float(loss.get("lambda_c", 1.0)) * l_coarse \
        + float(loss.get("lambda_o", 1.0)) * l_off


def cosine_lr(base: float, eta_min: float, total: int, count: int) -> float:
    """The cosine decay from `base` to `eta_min` over `total` steps."""
    count = min(count, total)
    alpha = eta_min / base
    return base * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / total))
                   + alpha)


class AdamW:
    """torch.optim.AdamW's update, written out (decoupled decay)."""

    def __init__(self, params: dict, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-2):
        self.p, self.b1, self.b2 = params, betas[0], betas[1]
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = self.m[k] / (1 - self.b1 ** self.t)
            vh = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(lr * mh / (vh.sqrt() + self.eps))
