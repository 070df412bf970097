"""`correct` for the training cells: the Trainer's first steps, held
against the plain reference (benchmark/reference/train.py).

The reference starts from the same initial parameters (the benchmark drew
them from the seed) and follows the program's first steps on the same
batches (the program's host batch building over the benchmark's scenes:
the reference takes its batches as they were given to the step, and
`batch_repeated` checks that no step repeats an earlier one's batch). Compared,
by the worst step or leaf:

- `loss_relgap_step1`: the first step's loss, as a share of the
  reference's (the later steps' losses are reported beside it and not
  compared: under the tpu.bf16 rule they part from float32 by rounding
  that AdamW's per-element scaling turns into whole steps, up to 5% by
  the third step on sound runs, as far as the control);
- `grad_norm_gap`: the first gradient as AdamW got it (its first moment
  after one step over 1 - beta1), the gap between the norms of a leaf,
  over the reference's norm of the leaf or of the median leaf, whichever
  is larger;
- `update_norm_gap_median`: the same for the parameters' change over the
  steps, the median leaf's (the worst leaf's is reported beside it: a
  small leaf's change reads the same scaled rounding).

A packed attention projection counts as its three leaves (q, k, v).
Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding: they move by round-off alone under AdamW) are
left out of both gaps; the frozen loop head is not trained.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import train as reft


def _trainable(key) -> bool:
    part, name = key
    return part == "encoder" or not name.startswith("loop")


def _tree(leaves: dict) -> dict:
    """Port-named leaves -> the reference's Flax-layout tree of views."""
    tree = {"encoder": {}, "decoder": {}}
    for (part, name), t in leaves.items():
        *scope, leaf = name.split(".")
        if leaf == "in_proj_weight":
            leaf, t = "in_proj_kernel", t.T
        elif leaf == "weight":
            leaf, t = ("kernel", t.T) if t.dim() == 2 else ("scale", t)
        node = tree[part]
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = t
    return tree


def follow(rec, p0, args, device, prec: str):
    """The reference's steps on the program's batches from `p0` ->
    (losses, first gradient by leaf, change by leaf)."""
    leaves = {k: v.detach().clone().to(device).requires_grad_(_trainable(k))
              for k, v in p0.items()}
    model = dict(encoder=dict(args.encoder), decoder=dict(args.decoder))
    reg = args.train.registration
    opt_kw = dict(reg.optimizer.get("kwargs", {}))
    base = float(opt_kw.get("lr", 1e-3))
    sched = reg.get("scheduler") or {}
    eta_min = float(dict(sched.get("kwargs", {})).get("eta_min", 0.0))
    total = int(rec["total_steps"])
    trained = {k: v for k, v in leaves.items() if _trainable(k)}
    opt = reft.AdamW(trained, betas=tuple(opt_kw.get("betas", (0.9, 0.999))),
                     weight_decay=float(opt_kw.get("weight_decay", 1e-2)))
    losses, g1 = [], None
    for t, batch in enumerate(rec["batches"]):
        ref = reft.TrainRef(_tree(leaves), model, prec)
        b = {f: torch.as_tensor(np.asarray(getattr(batch, f))).to(device)
             for f in batch._fields}
        for f in ("points", "group_SE3", "gt_R", "gt_t"):
            b[f] = b[f].float()
        b["valid"] = b["valid"].bool()
        loss = ref.step_loss(b, float(args.slam_system.coor_scale),
                             dict(args.loss),
                             int(reg.get("max_pairs", 1024)))
        keys = list(trained)
        grads = torch.autograd.grad(loss, [trained[k] for k in keys],
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(trained[k]))
                 for k, g in zip(keys, grads)}
        if t == 0:
            g1 = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads, reft.cosine_lr(base, eta_min, total, t)
                 if sched.get("type", "identity") != "identity" else base)
        losses.append(float(loss.detach()))
    change = {k: (trained[k].detach() - p0[k].to(device)) for k in trained}
    return losses, g1, change


def split_leaves(by_name: dict) -> dict:
    """A packed attention projection (q | k | v stacked, the port's and
    Flax's in_proj) as its three leaves: the key's bias takes no gradient
    under softmax, and only apart can the rule below leave it out."""
    out = {}
    for k, t in by_name.items():
        if k[1].endswith(("in_proj_weight", "in_proj_bias")):
            for i, part in enumerate(t.chunk(3, dim=0)):
                out[(k[0], f"{k[1]}[{'qkv'[i]}]")] = part
        else:
            out[k] = t
    return out


def _norm_gaps(prog: dict, ref: dict, keep) -> dict:
    med = float(np.median([float(ref[k].norm()) for k in keep]))
    return {k: abs(float(prog[k].norm()) - float(ref[k].norm()))
            / max(float(ref[k].norm()), med, 1e-30) for k in keep}


def numbers(losses_p, g1_p, change_p, losses_r, g1_r, change_r,
            info=None) -> dict:
    g1_p, g1_r, change_p, change_r = (split_leaves(x) for x in (
        g1_p, g1_r, change_p, change_r))
    norms = {k: float(g.norm()) for k, g in g1_r.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, n in norms.items() if n >= 1e-3 * med]
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(losses_p, losses_r)]
    grad, upd = _norm_gaps(g1_p, g1_r, keep), _norm_gaps(change_p, change_r,
                                                          keep)
    if info is not None:
        worst = lambda d: sorted(((round(v, 5), ".".join(k)) for k, v in
                                  d.items()), reverse=True)[:3]
        info.update(loss_relgap_steps=gaps,
                    update_norm_gap_worst=max(upd.values()),
                    worst_grad_leaves=worst(grad),
                    worst_update_leaves=worst(upd),
                    left_out=[".".join(k) for k in norms if k not in keep])
    return {"loss_relgap_step1": gaps[0],
            "grad_norm_gap": max(grad.values()),
            "update_norm_gap_median": float(np.median(list(upd.values())))}


def _repeated_batches(batches) -> int:
    """Checked steps whose batch repeats an earlier one's points."""
    seen, rep = set(), 0
    for b in batches:
        key = np.asarray(b.points).tobytes()
        rep += key in seen
        seen.add(key)
    return rep


def compare(rec, p0, args, device, controls=()) -> tuple:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses_r, g1_r, change_r = follow(rec, p0, args, device, "f32")
    p3 = rec["p3"]
    change_p = {k: p3[k] - p0[k].to(device) for k in change_r}
    g1_p = {k: rec["g1"][k] for k in g1_r}
    info = {"losses_program": rec["losses"], "losses_reference": losses_r}
    nums = numbers(rec["losses"], g1_p, change_p, losses_r, g1_r, change_r,
                   info)
    nums["batch_repeated"] = _repeated_batches(rec["batches"])
    ctl = {}
    for prec in controls:
        lc, gc, cc = follow(rec, p0, args, device, prec)
        ctl[prec] = numbers(lc, gc, cc, losses_r, g1_r, change_r)
    return nums, ctl, info
