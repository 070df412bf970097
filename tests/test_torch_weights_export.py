"""The port's writer of the reference's `.pth` schema (`save_torch_weight`)
against the JAX package's writer, its own reader, and the JAX package's
reader and engine."""

import numpy as np
import pytest
import torch
from flax import serialization

from deeppointmap_tpu.config import config_from_yaml as j_config_from_yaml
from deeppointmap_tpu.models.weights import load_torch_weight as j_load_pth
from deeppointmap_tpu.models.weights import save_torch_weight as j_save_pth
from deeppointmap_tpu_torch.config import config_from_dict, config_from_yaml
from deeppointmap_tpu_torch.models.decoder import Decoder
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.models.weights import (flax_tree_from_state_dict,
                                                   load_msgpack_weights,
                                                   load_torch_weight,
                                                   save_torch_weight)
from deeppointmap_tpu_torch.pipeline.common import init_params

torch.set_num_threads(2)

SAMPLE = "configs/infer/sample.yaml"
OCC = "artifacts/full_size_occ_v2/weights_final.msgpack"
FULL = "artifacts/full_size/weights_final.msgpack"


def _modules(args, enc_sd, dec_sd):
    enc, dec = Encoder.from_config(args), Decoder.from_config(args)
    enc.load_state_dict(enc_sd)
    dec.load_state_dict(dec_sd)
    return enc, dec


@pytest.mark.parametrize("given", ["modules", "state_dicts", "flax_trees"])
def test_pth_equals_the_jax_writers(tmp_path, given):
    """From the committed occluded checkpoint, the port's file holds the
    JAX package's keys in the JAX writer's order, with the same shapes and
    dtypes and values equal bit for bit, whichever form of the model the
    port's writer is given."""
    args = config_from_yaml(SAMPLE)
    enc_sd, dec_sd = load_msgpack_weights(OCC)
    models = {"modules": _modules(args, enc_sd, dec_sd),
              "state_dicts": (enc_sd, dec_sd),
              "flax_trees": ({"params": flax_tree_from_state_dict(enc_sd)},
                             flax_tree_from_state_dict(dec_sd))}[given]
    save_torch_weight(str(tmp_path / "port.pth"), *models, args)

    with open(OCC, "rb") as f:
        blob = serialization.msgpack_restore(f.read())
    j_save_pth(str(tmp_path / "jax.pth"), {"params": blob["encoder"]},
               {"params": blob["decoder"]}, j_config_from_yaml(SAMPLE))

    got = torch.load(tmp_path / "port.pth", weights_only=True)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert list(got) == list(want) == ["encoder", "decoder"]
    for part in want:
        assert list(got[part]) == list(want[part]), part
        for k, w in want[part].items():
            g = got[part][k]
            assert g.device.type == "cpu" and g.is_contiguous(), k
            assert g.dtype == w.dtype == torch.float32, k
            assert g.shape == w.shape, k
            assert torch.equal(g, w), k


@pytest.mark.parametrize("source", ["full_size", "occ_v2", "random"])
def test_pth_round_trips_through_the_ports_reader(tmp_path, source):
    """load_torch_weight(save_torch_weight(x)) == x, bit for bit, for both
    committed full-size checkpoints and a seeded random model."""
    args = config_from_yaml(SAMPLE)
    if source == "random":
        enc_sd, dec_sd = init_params(args, torch.Generator().manual_seed(4))
    else:
        enc_sd, dec_sd = load_msgpack_weights(FULL if source == "full_size"
                                              else OCC)
    path = str(tmp_path / "w.pth")
    save_torch_weight(path, enc_sd, dec_sd, args)
    for got, want in zip(load_torch_weight(path, args), (enc_sd, dec_sd)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k


def test_port_model_in_pth_runs_in_the_jax_engine(tmp_path):
    """A small random model of the port, written as `.pth`, is read by the
    JAX package's `load_torch_weight`; the JAX engine and the port's engine
    then extract the same scan alike, within tests/test_torch_engine.py's
    tolerance (host-normalized input: the same points reach both
    encoders)."""
    from deeppointmap_tpu.pipeline.common import init_params as j_init
    from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine
    from tests.test_torch_engine import (_check_host_extract, _normalized,
                                         frames)
    from tests.test_torch_models import SMALL, jax_args

    targs, jargs = config_from_dict(SMALL), jax_args()
    enc_sd, dec_sd = init_params(targs, torch.Generator().manual_seed(7))
    path = str(tmp_path / "small.pth")
    save_torch_weight(path, enc_sd, dec_sd, targs)
    enc, dec, _, _ = j_init(jargs, seed=0)
    enc_p, dec_p = j_load_pth(path, jargs)
    j_eng = JEngine(jargs, enc_p, dec_p, encoder=enc, decoder=dec,
                    preprocess_cfg=None)
    t_eng = InferenceEngine(targs, enc_sd, dec_sd, preprocess_cfg=None,
                            device="cpu")
    pts, valid = frames(2)
    for i in range(len(pts)):
        x = _normalized(pts[i:i + 1])
        _check_host_extract(t_eng.extract(x, valid[i:i + 1]),
                            j_eng.extract(x, valid[i:i + 1]))
