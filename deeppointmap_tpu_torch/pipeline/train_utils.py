"""Training utilities: schedules, optimizers and the metric recorder (port
of deeppointmap_tpu/pipeline/train_utils.py, with torch.optim in place of
optax).

The schedules are optax's closed forms, evaluated in float64: `identity`
(constant), `cosine` (optax.cosine_decay_schedule, which holds its last
value past `total` where torch's CosineAnnealingLR would turn back up) and
`cosine_restart` (optax.join_schedules of such decays). A LambdaLR stepped
once per optimizer step gives step i the value schedule(i), as optax does.
AdamW's decoupled decay is optax.adamw's (eps 1e-8, `betas` from the
kwargs); SGD with momentum is optax.sgd's trace (dampening 0).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch


def _cosine(base_lr: float, decay_steps: int, alpha: float) -> Callable:
    """optax.cosine_decay_schedule(base_lr, decay_steps, alpha)."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def build_schedule(sched_cfg, base_lr: float, steps_per_epoch: int,
                   num_epochs: int) -> Callable[[int], float]:
    """identity / cosine / cosine-restart (reference: pipeline/modules/
    utils.py:103-125, keyed the same way) -> schedule(step) -> lr."""
    kind = (sched_cfg.get("type", "identity") if sched_cfg else "identity")
    kwargs = dict(sched_cfg.get("kwargs", {})) if sched_cfg else {}
    total = max(steps_per_epoch * num_epochs, 1)
    kind = kind.lower()
    if kind in ("identity", "none", "constant"):
        return lambda count: base_lr
    eta_min = float(kwargs.get("eta_min", 0.0))
    alpha = eta_min / max(base_lr, 1e-12)
    if kind in ("cos", "cosine", "cosineannealinglr"):
        return _cosine(base_lr, total, alpha)
    if kind in ("cosine_restart", "cosineannealingwarmrestarts"):
        t0 = int(kwargs.get("T_0", num_epochs)) * steps_per_epoch
        n = max(total // t0, 1)
        decay = _cosine(base_lr, t0, alpha)
        boundaries = [t0 * (i + 1) for i in range(n - 1)]

        def joined(count: int) -> float:
            # optax.join_schedules: the last boundary passed restarts it
            start = max([b for b in boundaries if count >= b], default=0)
            return decay(count - start)
        return joined
    raise ValueError(f"unknown scheduler type: {kind}")


def build_optimizer(opt_cfg, params, schedule: Callable[[int], float]):
    """adamw / adam / sgd (reference: pipeline/modules/utils.py:86-100)
    over `params` -> (optimizer, LambdaLR scheduler). The optimizer's lr
    is schedule(0); the scheduler scales it to schedule(i) at step i."""
    kind = opt_cfg.get("type", "adamw").lower()
    kwargs = dict(opt_cfg.get("kwargs", {}))
    kwargs.pop("lr", None)
    lr0 = float(schedule(0))
    params = list(params)
    if kind == "adamw":
        betas = tuple(kwargs.get("betas", (0.9, 0.999)))
        opt = torch.optim.AdamW(params, lr=lr0, betas=betas, eps=1e-8,
                                weight_decay=float(kwargs.get(
                                    "weight_decay", 1e-2)))
    elif kind == "adam":
        opt = torch.optim.Adam(params, lr=lr0, eps=1e-8)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr0,
                              momentum=float(kwargs.get("momentum", 0.0)))
    else:
        raise ValueError(f"unknown optimizer type: {kind}")
    scale = (lambda i: schedule(i) / lr0) if lr0 != 0 else (lambda i: 0.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, scale)


class Recorder:
    """Metric aggregation with min/max/mean reductions
    (reference: pipeline/modules/utils.py:15-83)."""

    def __init__(self):
        self._data: Dict[str, List[float]] = {}

    def add_dict(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._data.setdefault(k, []).append(float(v))

    def add_item(self, key: str, value: float) -> None:
        self._data.setdefault(key, []).append(float(value))

    def mean(self, key: str) -> float:
        return float(np.mean(self._data[key]))

    def min(self, key: str) -> float:
        return float(np.min(self._data[key]))

    def max(self, key: str) -> float:
        return float(np.max(self._data[key]))

    def keys(self):
        return self._data.keys()

    def clear(self) -> None:
        self._data.clear()

    def summary(self) -> Dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self._data.items()}
