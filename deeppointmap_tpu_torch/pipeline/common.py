"""Shared pipeline helpers: model construction and weight loading (port of
deeppointmap_tpu/pipeline/common.py)."""

from __future__ import annotations

import logging

import torch

from deeppointmap_tpu_torch.models.decoder import Decoder
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.models.weights import (load_msgpack_weights,
                                                   load_torch_weight)

logger = logging.getLogger(__name__)


def init_params(args, generator: torch.Generator):
    """Randomly initialized encoder / decoder state dicts with the
    configured shapes, every parameter drawn anew from `generator` (normal,
    std 0.02; biases zero, norm scales one), so that a seed fixes them."""
    states = []
    for model in (Encoder.from_config(args), Decoder.from_config(args)):
        sd = model.state_dict()
        for name, p in sd.items():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() < 2:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        states.append(sd)
    return tuple(states)


def load_weights(args, weight_path: str):
    """-> (encoder state dict, decoder state dict) from a `.msgpack`
    checkpoint of the JAX package, or from a `.pth` file in the
    reference's schema ({'encoder': sd, 'decoder': sd}; models/weights.py
    maps either onto the port's modules)."""
    if weight_path.endswith(".msgpack"):
        return load_msgpack_weights(weight_path)
    if weight_path.endswith((".pth", ".pt", ".ckpt")):
        return load_torch_weight(weight_path, args)
    raise ValueError(f"unsupported weight format: {weight_path}")


def build_models(args, weight: str = "", seed: int = 0):
    """-> (encoder state dict, decoder state dict): loaded from `weight`,
    or randomly initialized from `seed` when none is given."""
    if weight:
        logger.info("loading weights from %s", weight)
        return load_weights(args, weight)
    logger.warning("no --weight given: using randomly initialized models")
    return init_params(args, torch.Generator().manual_seed(seed))


def infer_padding(args) -> int:
    """Static point count of the encoder input. The reference pads
    dynamically (`padding_to: -1`, configs/infer/*.yaml:29); both packages
    here always pad to `tpu.encoder_points`."""
    return int(args.tpu.encoder_points)
