"""One rank of the port's data-parallel checks (tests/test_torch_ddp.py
on the CPU over gloo; scripts/train_ddp_check.py on GPUs over NCCL): joins
the process group, builds the Trainer from the config and parameters the
caller wrote to <work>, and takes one step of each stage on its slice of
the first global batch, then `--time_steps` timed stage-1 steps. Writes
rank<r>.pt (the metrics, this rank's valid points, the parameters after
each stage's step, the step seconds); exits 3 when the determinism probe
refuses to start.

    python tests/test_torch_ddp_worker.py --rank 0 --world 2 --port 29512 \
        --work <dir> [--seed 0] [--device cpu|cuda] [--time_steps 0] \
        [--watchdog_s 0]

With --watchdog_s, a rank still running after that many seconds prints
every thread's stack and exits (a collective that never completes shows
where it waits).
"""

import argparse
import faulthandler
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deeppointmap_tpu_torch.config import config_from_dict  # noqa: E402
from deeppointmap_tpu_torch.data.dataset import SlamDatasets  # noqa: E402
from deeppointmap_tpu_torch.parallel.ddp import (  # noqa: E402
    init_process_group)
from deeppointmap_tpu_torch.pipeline.train import (  # noqa: E402
    training_transforms)
from deeppointmap_tpu_torch.pipeline.trainer import Trainer  # noqa: E402


def step_stages(trainer, time_steps: int = 0) -> dict:
    """One step of stage 1, then of stage 2, each on the first batch of
    its stage: {stage: (metrics, valid points of this slice, params on
    the CPU)}; with `time_steps`, also "step_s": the seconds of that many
    more stage-1 steps (batch building, the step and its host sync)."""
    out = {}
    for stage in (1, 2):
        trainer.stage = stage
        trainer._setup_stage()
        batch = next(trainer._iter_batches())
        mine = trainer.ddp.shard(batch)
        valid = [np.asarray(x).sum() for x in mine
                 if np.asarray(x).dtype == bool]
        metrics = trainer.train_step(batch)
        params = {f"{part}.{k}": v.detach().cpu().clone() for part, m in (
            ("encoder", trainer.encoder), ("decoder", trainer.decoder))
            for k, v in m.state_dict().items()}
        out[stage] = (metrics, [int(v) for v in valid], params)
    if time_steps:
        trainer.stage = 1
        trainer._setup_stage()
        batches, secs = trainer._iter_batches(), []
        for _ in range(time_steps):
            t0 = time.perf_counter()
            trainer.train_step(next(batches))
            secs.append(time.perf_counter() - t0)
        out["step_s"] = secs
    return out


def build(work: str, seed: int, device: str = "cpu") -> Trainer:
    with open(os.path.join(work, "cfg.json")) as f:
        args = config_from_dict(json.load(f))
    enc_sd, dec_sd = torch.load(os.path.join(work, "params.pt"),
                                weights_only=True)
    rng = np.random.default_rng(seed)
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    return Trainer(args, ds, enc_sd, dec_sd, rng=rng, device=device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--time_steps", type=int, default=0)
    ap.add_argument("--watchdog_s", type=float, default=0.0)
    ns = ap.parse_args()
    if ns.watchdog_s > 0:
        faulthandler.dump_traceback_later(ns.watchdog_s, exit=True)
    torch.set_num_threads(1)
    device = "cpu"
    if ns.device == "cuda":
        torch.cuda.set_device(ns.rank)
        device = f"cuda:{ns.rank}"
    init_process_group(f"tcp://127.0.0.1:{ns.port}", ns.world, ns.rank,
                       ns.device)
    try:
        try:
            trainer = build(ns.work, ns.seed, device)
        except RuntimeError as e:
            print(f"refused: {e}", flush=True)
            return 3
        torch.save(step_stages(trainer, ns.time_steps),
                   os.path.join(ns.work, f"rank{ns.rank}.pt"))
        trainer.close()
        return 0
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
