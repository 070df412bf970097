"""Trainer: the two-stage curriculum training loop with checkpoints and
resume (port of deeppointmap_tpu/pipeline/trainer.py).

Parity with the reference Trainer (reference: pipeline/modules/
trainer.py:30-336): stage 1 trains registration (loop head frozen), stage 2
trains only the loop head; the curriculum grows K = K_0 * K_mult^(epoch //
mult_epoch), capped at K_max (trainer.py:131-140); checkpoints hold both
state dicts, the optimizer state, epoch, step and stage, and resume
re-selects the stage; metrics stream to metrics.jsonl (and TensorBoard
when it is installed).

Freezing: the JAX package zeroes frozen updates with optax.multi_transform
/ set_to_zero. Here frozen parameters are left out of the optimizer and
get requires_grad False, so they get neither an update nor weight decay,
and stage 2's encoder runs without grad; they stay bit for bit unchanged.

Data parallelism (parallel/ddp.py) replaces the JAX device mesh: one
process per device, `tpu.data_parallel: "auto"` = the process group's
world size; every rank builds the same global batch and steps on its
slice. Only rank 0 writes files.

Matrix products: the trainer resolves the `tpu.bf16` rule for its device
(utils/precision.py) and gives it to both models, so that on a card the
network's products and their gradients take bfloat16 operands and float32
accumulation, as the JAX package's step does on the TPU (parameters, the
optimizer's state and the loss's reductions stay float32);
`matmul_policy` forces a policy.

Batches: `pipeline/batching.BatchBuilder` builds each epoch's batches.
With `num_workers` >= 1 a producer process (pipeline/producer.py) runs it
ahead of the step, started with the Trainer and fed its builder at the
first epoch (from then on it owns the generator); with 0, or none given,
the loop builds each batch itself when it needs it. Either way the batches
are the same, byte for byte.

Besides metrics.jsonl (running means every `log_cycle` steps) every step
appends one line to steps.jsonl: the step's metrics, `batch_s` (the host
seconds the loop waited for its batch: the whole build on the serial
path), `batch_ready` (whether the producer had the batch ready when the
loop asked; false on the serial path), the seconds of the step (ending in
the metrics' one host sync), the device's peak allocated bytes, the
kernel launches by shape, and `spans`: the host seconds of the step's
spans (utils/timer.py; a `train.step` scope around the batch and its
step): `train.read` (scan reads), `train.transform` (the host transforms),
`train.assemble` (the batch's assembly), timed in the loop or by the
producer for this batch, and `train.sync` (the metrics' host sync),
inclusive.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.models.decoder import Decoder
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.models.loss import LossConfig
from deeppointmap_tpu_torch.parallel.ddp import DataParallel
from deeppointmap_tpu_torch.parallel.train_step import (
    loop_param_mask, make_loop_train_step, make_registration_train_step,
    to_device)
from deeppointmap_tpu_torch.pipeline.batching import BatchBuilder, EpochPlan
from deeppointmap_tpu_torch.pipeline.common import load_weights, save_weights
from deeppointmap_tpu_torch.pipeline.producer import Producer
from deeppointmap_tpu_torch.pipeline.train_utils import (Recorder,
                                                         build_optimizer,
                                                         build_schedule)
from deeppointmap_tpu_torch.utils import precision, timer

logger = logging.getLogger(__name__)

_CKPT = re.compile(r"checkpoint_ep(\d+)\.pt$")


def registration_param_mask(part: str, name: str) -> bool:
    """True = trainable in stage 1: everything but the loop head
    (reference: model_pipeline.py:183-189)."""
    return part == "encoder" or not name.startswith("loop")


def newest_checkpoint(path: str) -> str:
    """`path` itself, or the newest checkpoint_ep<N>.pt in the directory."""
    if not os.path.isdir(path):
        return path
    found = sorted((int(m.group(1)), f) for f in os.listdir(path)
                   if (m := _CKPT.match(f)))
    if not found:
        raise FileNotFoundError(f"no checkpoint_ep<N>.pt under {path}")
    return os.path.join(path, found[-1][1])


class Trainer:
    def __init__(self, args, dataset, enc_sd, dec_sd,
                 rng: Optional[np.random.Generator] = None,
                 device="cuda", matmul_policy=None):
        self.args = args
        self.cfg = args.train
        # the producer's interpreter starts first: it imports while the
        # models are built
        workers = int(args.get("num_workers") or 0)
        self._producer = Producer(workers) if workers >= 1 else None
        self._batch_ready = False
        self.dataset = dataset
        self.device = torch.device(device)
        if self.device.type == "cuda":
            kernels.strict_matmuls()
        self.matmul_policy = precision.resolve(matmul_policy, args.get("tpu"),
                                               self.device)
        self.encoder = Encoder.from_config(args, self.matmul_policy)
        self.decoder = Decoder.from_config(args, self.matmul_policy)
        self.encoder.load_state_dict(enc_sd)
        self.decoder.load_state_dict(dec_sd)
        self.encoder.to(self.device)
        self.decoder.to(self.device)
        self.rng = rng or np.random.default_rng(0)
        self.loss_cfg = LossConfig.from_args(args)
        self.coor_scale = float(args.slam_system.coor_scale)
        self.pad_to = int(args.tpu.encoder_points)
        self.ddp = DataParallel.from_config(args.tpu.get("data_parallel",
                                                         "auto"))
        self.ddp.check_determinism(self.rng, len(dataset), self.device)
        self.is_main = self.ddp.rank == 0

        self.stage_epochs = [self.cfg.registration.num_epochs,
                             self.cfg.loop_detection.num_epochs]
        self.epoch = 0
        self.step = 0
        self.stage = 1
        self.log_dir = args.get("infer_tgt") or "./log_train"
        self._metrics_file = self._steps_file = self._tb = None
        if self.is_main:
            os.makedirs(self.log_dir, exist_ok=True)
            self._metrics_file = open(
                os.path.join(self.log_dir, "metrics.jsonl"), "a")
            self._steps_file = open(
                os.path.join(self.log_dir, "steps.jsonl"), "a")
            # TensorBoard scalars (reference: trainer.py:98,186-199)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(self.log_dir, "tb"))
            except ImportError:
                self._tb = None
            self._snapshot_source()
        self._setup_stage()

    def close(self) -> None:
        if self._producer is not None:
            self._producer.close()
        for f in (self._metrics_file, self._steps_file, self._tb):
            if f is not None:
                f.close()
        self._metrics_file = self._steps_file = self._tb = None

    def _snapshot_source(self) -> None:
        """Zip the port's package source into the run directory
        (reference: trainer.py:67-71)."""
        import zipfile

        import deeppointmap_tpu_torch

        pkg_root = os.path.dirname(os.path.abspath(
            deeppointmap_tpu_torch.__file__))
        out = os.path.join(self.log_dir, "source_snapshot.zip")
        try:
            with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
                for root, _, files in os.walk(pkg_root):
                    for f in files:
                        if f.endswith((".py", ".cu", ".cuh")):
                            p = os.path.join(root, f)
                            z.write(p, os.path.relpath(
                                p, os.path.dirname(pkg_root)))
        except OSError as e:
            logger.warning("source snapshot failed: %s", e)

    def _batch_items(self) -> int:
        """Dataset items per global step, rounded up to a multiple of the
        ranks so that the batch axis splits evenly (each item gives num_map
        groups in stage 1)."""
        bs = (self.cfg.registration.batch_size if self.stage == 1
              else self.cfg.loop_detection.batch_size)
        bs = max(int(bs), 1)
        n = self.ddp.world
        rounded = ((bs + n - 1) // n) * n
        if rounded != bs:
            logger.warning("batch_size %d rounded up to %d (%d ranks)",
                           bs, rounded, n)
        return rounded

    def _steps_per_epoch(self) -> int:
        return max(len(self.dataset) // self._batch_items(), 1)

    def _setup_stage(self) -> None:
        """(Re)build the optimizer, its schedule and the step for the
        current stage (reference stage switch: trainer.py:313-336)."""
        if self.stage == 1:
            cfg = self.cfg.registration
            self.dataset.registration()
            mask = registration_param_mask
        else:
            cfg = self.cfg.loop_detection
            self.dataset.loop_detection()
            mask = loop_param_mask
        params = []
        for part, model in (("encoder", self.encoder),
                            ("decoder", self.decoder)):
            for name, p in model.named_parameters():
                p.requires_grad_(mask(part, name))
                if p.requires_grad:
                    params.append(p)
        lr = float(cfg.optimizer.get("kwargs", {}).get("lr", 1e-3))
        schedule = build_schedule(cfg.get("scheduler"), lr,
                                  self._steps_per_epoch(), cfg.num_epochs)
        self.optimizer, self.scheduler = build_optimizer(cfg.optimizer, params,
                                                         schedule)
        if self.stage == 1:
            self._step = make_registration_train_step(
                self.encoder, self.decoder, self.loss_cfg, self.optimizer,
                self.scheduler, self.coor_scale,
                max_pairs=int(self.cfg.registration.get("max_pairs", 1024)),
                remat=bool(self.args.tpu.get("remat", False)), ddp=self.ddp)
        else:
            self._step = make_loop_train_step(
                self.encoder, self.decoder, self.optimizer, self.scheduler,
                self.coor_scale, ddp=self.ddp)

    def train_step(self, batch) -> dict:
        """One optimizer step on a host batch: this rank's slice, moved to
        the device. -> the metrics over the global batch."""
        return self._step(to_device(self.ddp.shard(batch), self.device))

    def _curriculum_K(self) -> int:
        """K = min(K_0 * K_mult^(epoch // mult_epoch), K_max)
        (reference: trainer.py:131-140)."""
        cfg = self.cfg.registration
        times = self.epoch // int(cfg.get("mult_epoch", 1e9) or 1e9)
        k = int(cfg.get("K_0", cfg.K) * (cfg.get("K_mult", 1.0) ** times))
        return min(max(k, 2), int(cfg.get("K_max", cfg.K)))

    # ------------------------------------------------------------- train
    def run(self) -> None:
        total_epochs = sum(self.stage_epochs)
        while self.epoch < total_epochs:
            if self.stage == 1 and self.epoch >= self.stage_epochs[0]:
                logger.info("=== stage 2 (loop detection) begins")
                self.stage = 2
                self._setup_stage()
            self.train_one_epoch()
            self.epoch += 1
            if self.epoch % int(self.cfg.get("save_cycle", 1)) == 0:
                self.save()
        self.save(final=True)

    def _iter_batches(self):
        """Host batches of the current stage's epoch (BatchBuilder), built
        here when asked for, or taken from the producer; each sets
        `_batch_ready`, and the producer's spans for it go to the scope
        open here (the step's)."""
        plan = EpochPlan(self.stage, self._curriculum_K(),
                         self._steps_per_epoch(), self._batch_items())
        builder = BatchBuilder(self.dataset, self.rng, self.cfg, self.pad_to)
        if self._producer is None:
            for batch in builder.epoch(plan):
                self._batch_ready = False
                yield batch
            return
        if plan.stage == 1:
            self.dataset.registration_cfg.K = plan.K
        for batch, spans, ready in self._producer.batches(builder, plan):
            timer.add(spans)
            self._batch_ready = ready
            yield batch

    def _launch_counts(self) -> Counter:
        return Counter({(k.name, sh): c for k in kernels.ALL
                        for sh, c in k.shapes.items()})

    def train_one_epoch(self) -> None:
        rec = Recorder()
        t0 = time.time()
        log_cycle = int(self.cfg.get("log_cycle", 50))
        cuda = self.device.type == "cuda"
        batches = self._iter_batches()
        i = 0
        while True:
            with timer.scope("train.step", self.step + 1) as spans:
                t_batch = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                t_step = time.perf_counter()
                before = self._launch_counts()
                metrics = self.train_step(batch)
                t_end = time.perf_counter()
            self.step += 1
            rec.add_dict(metrics)
            if self._steps_file is not None:
                launched = self._launch_counts() - before
                self._steps_file.write(json.dumps(dict(
                    stage=self.stage, epoch=self.epoch, step=self.step,
                    metrics=metrics, batch_s=t_step - t_batch,
                    batch_ready=self._batch_ready, step_s=t_end - t_step,
                    peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                                if cuda else None),
                    launches=[[k, list(sh), c] for (k, sh), c in
                              sorted(launched.items())],
                    spans=spans)) + "\n")
            i += 1
            if i % log_cycle == 0 and self._metrics_file is not None:
                summary = rec.summary()
                summary.update(epoch=self.epoch, step=self.step,
                               stage=self.stage,
                               sec_per_step=(time.time() - t0) / i)
                self._metrics_file.write(json.dumps(summary) + "\n")
                self._metrics_file.flush()
                self._steps_file.flush()
                if self._tb is not None:
                    for k, v in summary.items():
                        self._tb.add_scalar(f"stage{self.stage}/{k}", v,
                                            self.step)
                logger.info("epoch %d step %d %s", self.epoch, self.step,
                            {k: round(v, 4) for k, v in summary.items()})
        if self._steps_file is not None:
            self._steps_file.flush()
        logger.info("epoch %d done in %.1fs: %s", self.epoch,
                    time.time() - t0,
                    {k: round(v, 4) for k, v in rec.summary().items()})

    # -------------------------------------------------------- checkpoint
    def _ckpt_dir(self) -> str:
        return os.path.join(self.log_dir, "checkpoints")

    def save(self, final: bool = False) -> None:
        """Checkpoint both state dicts, the optimizer and schedule state,
        epoch, step and stage under <log_dir>/checkpoints/, keeping the
        newest `train.keep_checkpoints` (reference: trainer.py:210-233);
        the final save writes weights_final.msgpack only. Rank 0 writes."""
        if not self.is_main:
            return
        if final:
            save_weights(os.path.join(self.log_dir, "weights_final.msgpack"),
                         self.encoder.state_dict(), self.decoder.state_dict())
            return
        os.makedirs(self._ckpt_dir(), exist_ok=True)
        path = os.path.join(self._ckpt_dir(),
                            f"checkpoint_ep{self.epoch}.pt")
        torch.save({"encoder": self.encoder.state_dict(),
                    "decoder": self.decoder.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "scheduler": self.scheduler.state_dict(),
                    "epoch": self.epoch, "step": self.step,
                    "stage": self.stage}, path)
        keep = int(self.cfg.get("keep_checkpoints", 3))
        found = sorted((int(m.group(1)), f)
                       for f in os.listdir(self._ckpt_dir())
                       if (m := _CKPT.match(f)))
        for _, f in found[:-keep] if keep > 0 else []:
            os.remove(os.path.join(self._ckpt_dir(), f))
        logger.info("saved checkpoint %s", path)

    def load_checkpoint(self, path: str) -> None:
        """Resume training (reference: trainer.py:250-293) from a
        checkpoint file or the checkpoints directory (its newest). The
        optimizer state is restored, except exactly at the stage boundary,
        where the reference starts it afresh (trainer.py:272-291)."""
        path = newest_checkpoint(path)
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.epoch = int(blob["epoch"])
        self.step = int(blob["step"])
        self.stage = int(blob["stage"])
        self.encoder.load_state_dict(blob["encoder"])
        self.decoder.load_state_dict(blob["decoder"])
        self._setup_stage()
        at_boundary = (self.stage == 1
                       and self.epoch == self.stage_epochs[0])
        if not at_boundary:
            self.optimizer.load_state_dict(blob["optimizer"])
            self.scheduler.load_state_dict(blob["scheduler"])

    def load_weight(self, path: str) -> None:
        """Weights only, with a fresh optimizer
        (reference: trainer.py:295-311)."""
        enc_sd, dec_sd = load_weights(self.args, path)
        self.encoder.load_state_dict(enc_sd)
        self.decoder.load_state_dict(dec_sd)
        self._setup_stage()
