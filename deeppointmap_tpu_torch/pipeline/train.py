"""Training entry point (port of deeppointmap_tpu/pipeline/train.py).

    python -m deeppointmap_tpu_torch.pipeline.train --yaml_file train.yaml \
        [--weight w.msgpack] [--checkpoint <file or checkpoints dir>] \
        [--device cuda|cpu] [--distributed ...]

CLI parity with the reference (reference: pipeline/train.py:31-75). One
seeded np.random.Generator (`seed`, default 0) drives the transforms, the
dataset sampler and the trainer, in the JAX package's order. The training
transforms stop before `ToTensor`: batching pads to `tpu.encoder_points`.

More than one GPU: one process per device, joined here
(`--distributed`) with `--coordinator_address host:port --num_processes
N --process_id i`, or from torchrun's environment when no address is
given; `tpu.data_parallel: auto` then spans the group.

`tpu.bf16` (default true) runs the network's matrix products and their
gradients with bfloat16 operands and float32 accumulation on a CUDA
device, float32 elsewhere or when false (utils/precision.py); the
encoder's activations are bfloat16 under `tpu.encoder_bf16` on a CUDA
device; parameters and optimizer state stay float32 and TF32 stays off.
`train.auto_cast` does not apply (the JAX package ignores it too).
`tpu.checkpointer` does not apply either: checkpoints are torch.save files
(pipeline/trainer.py).
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import torch

from deeppointmap_tpu_torch.config import load_config, save_settings
from deeppointmap_tpu_torch.data.dataset import SlamDatasets
from deeppointmap_tpu_torch.data.transforms import (PointCloudTransforms,
                                                    ToTensor)
from deeppointmap_tpu_torch.parallel.ddp import init_process_group
from deeppointmap_tpu_torch.pipeline.common import build_models
from deeppointmap_tpu_torch.pipeline.trainer import Trainer

logger = logging.getLogger("deeppointmap_tpu_torch.train")


def init_distributed(args) -> str:
    """Join the process group (the reference's dist.init_process_group,
    train.py:42-46) -> this process's device."""
    address = str(args.coordinator_address or "")
    if address and "://" not in address:
        address = f"tcp://{address}"
    init_process_group(address, args.num_processes, args.process_id,
                       args.device)
    device = str(args.device)
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", torch.distributed.get_rank()
                                   % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    return device


def training_transforms(args, rng: np.random.Generator):
    """The yaml `transforms:` chain in train mode, without `ToTensor`."""
    tfs = PointCloudTransforms(args, mode="train", rng=rng)
    tfs.transforms.transforms = [t for t in tfs.transforms.transforms
                                 if not isinstance(t, ToTensor)]
    return tfs


def main(argv=None) -> Trainer:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = load_config(argv)
    args.mode = "train"
    device = init_distributed(args) if args.distributed else str(args.device)

    rng = np.random.default_rng(int(args.get("seed", 0) or 0))
    dataset = SlamDatasets(args, data_transforms=training_transforms(args,
                                                                     rng),
                           rng=rng)
    logger.info("dataset: %d frames over %d datasets", len(dataset),
                len(dataset.dataset_list))

    enc_sd, dec_sd = build_models(args, args.weight)
    trainer = Trainer(args, dataset, enc_sd, dec_sd, rng=rng, device=device)
    if trainer.is_main:
        save_settings(args, os.path.join(trainer.log_dir, "settings.yaml"))
    if args.checkpoint:
        trainer.load_checkpoint(args.checkpoint)
        logger.info("resumed from %s (epoch %d, stage %d)", args.checkpoint,
                    trainer.epoch, trainer.stage)
    try:
        trainer.run()
    finally:
        trainer.close()
        if args.distributed:
            torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
