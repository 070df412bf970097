"""Batch extraction over several devices (deeppointmap_tpu_torch/parallel/
sharded_extract.py) on the CPU: `[torch.device("cpu")] * n` stands for n
cards. Held to the port's own `InferenceEngine.extract` (float32 uploads,
atol 2e-5 as tests/test_sharded_extract.py holds the JAX extractor to its
engine), and to the JAX package's `make_sharded_extract` on the conftest's
8-device CPU mesh with the same weights (atol 2e-5: the packages' encoders
differ by float32 matmul rounding only, tests/test_torch_models.py);
validity identical in both."""

import json

import jax
import numpy as np
import pytest
import torch

from deeppointmap_tpu.parallel.mesh import make_mesh
from deeppointmap_tpu.parallel.sharded_extract import \
    make_sharded_extract as jax_sharded_extract
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
from deeppointmap_tpu_torch.models import encoder as tenc
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.parallel.sharded_extract import (
    extract_sequence, make_sharded_extract)
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from tests.test_sharded_extract import _clouds
from tests.test_slam_e2e import small_args
from tests.test_torch_engine import frames
from tests.test_torch_models import SMALL, jax_args

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX encoder, its params, port args, port encoder state, engine)."""
    args = small_args(tmp_path_factory.mktemp("shard"))
    # the offline extractor consumes float32 directly (no upload
    # quantization); compare against an unquantized engine
    args.tpu["upload_quant"] = "none"
    enc, _, enc_p, dec_p = init_params(args, seed=0)
    targs = config_from_dict(json.loads(json.dumps(args)))
    enc_sd, dec_sd = state_dicts_from_jax(enc_p, dec_p)
    engine = InferenceEngine(targs, enc_sd, dec_sd, device="cpu")
    return enc, enc_p, targs, enc_sd, engine


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_matches_engine(setup, n_dev):
    _, _, args, enc_sd, engine = setup
    pts, val = _clouds(np.random.default_rng(0), 4, 4096)
    extract = make_sharded_extract(Encoder.from_config(args), enc_sd,
                                   [CPU] * n_dev, engine.coor_scale)
    assert len(extract.replicas) == n_dev
    d, dv, pv = extract(pts, val)
    assert d.shape[0] == 4 and d.dtype == np.float32
    d_ref, dv_ref, pv_ref = engine.extract(pts, val)
    np.testing.assert_allclose(d, d_ref, atol=2e-5)
    np.testing.assert_array_equal(dv, dv_ref)
    np.testing.assert_array_equal(pv, pv_ref)


def test_replicas_take_the_rule_for_their_device(setup):
    """Each replica's matmul policy is the tpu.bf16 rule's for its own
    device, whatever the encoder handed in holds: float32 "unchanged" on
    the CPU with the defaults (bf16 on), "highest" with tpu.bf16 false."""
    _, _, args, enc_sd, _ = setup
    enc = Encoder.from_config(args, "bfloat16")
    policies = lambda ex: {m.matmul_policy for r in ex.replicas
                           for m in r.modules() if hasattr(m, "matmul_policy")}
    assert policies(make_sharded_extract(enc, enc_sd, [CPU] * 2, 60.0)) \
        == {"unchanged"}
    assert policies(make_sharded_extract(
        enc, enc_sd, [CPU], 60.0, tpu_cfg={"bf16": False})) == {"highest"}


def test_sharded_matches_jax_on_the_8_device_mesh(setup):
    enc, enc_p, args, enc_sd, engine = setup
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (conftest)")
    pts, val = _clouds(np.random.default_rng(0), 8, 4096)
    d_j, dv_j, pv_j = jax_sharded_extract(enc, enc_p, make_mesh(8),
                                          coor_scale=engine.coor_scale)(
        pts, val)
    d, dv, pv = make_sharded_extract(Encoder.from_config(args), enc_sd,
                                     [CPU] * 8, engine.coor_scale)(pts, val)
    np.testing.assert_allclose(d, d_j, atol=2e-5)
    np.testing.assert_array_equal(dv, dv_j)
    np.testing.assert_array_equal(pv, pv_j)


def test_extract_sequence_tail_padding(setup):
    """6 scans over 4 devices: one padded batch, cut back to 6."""
    _, _, args, enc_sd, engine = setup
    pts, val = _clouds(np.random.default_rng(1), 6, 4096)
    d, dv, pv = extract_sequence(Encoder.from_config(args), enc_sd,
                                 [CPU] * 4, engine.coor_scale, pts, val)
    assert d.shape[0] == dv.shape[0] == pv.shape[0] == 6
    d_ref, dv_ref, pv_ref = engine.extract(pts, val)
    np.testing.assert_allclose(d, d_ref, atol=2e-5)
    np.testing.assert_array_equal(dv, dv_ref)
    np.testing.assert_array_equal(pv, pv_ref)


def test_non_divisible_batch_raises(setup):
    _, _, args, enc_sd, engine = setup
    pts, val = _clouds(np.random.default_rng(2), 6, 2048)
    extract = make_sharded_extract(Encoder.from_config(args), enc_sd,
                                   [CPU] * 4, engine.coor_scale)
    with pytest.raises(ValueError, match="batch 6 not divisible by mesh "
                                         "size 4; pad with invalid scans"):
        extract(pts, val)


def test_default_devices_are_the_cuda_devices(setup):
    """With none given, every visible CUDA device; none here, so it
    raises rather than taking the CPU."""
    _, _, args, enc_sd, engine = setup
    if torch.cuda.is_available():
        pytest.skip("the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_extract(Encoder.from_config(args), enc_sd, None,
                             engine.coor_scale)


def test_preprocessing_with_the_sweep_graph(monkeypatch):
    """Raw-meter scans through device preprocessing with sweep_k > 0 (the
    sweep's candidates serve the first stage's grouping), over 2 devices at
    2 scans a device: equal to the engine with the same preprocessing."""
    served = []
    group = tenc._group_from_sweep
    monkeypatch.setattr(tenc, "_group_from_sweep", lambda *a: served.append(
        a[0].shape[0]) or group(*a))
    _, _, enc_p, dec_p = init_params(jax_args(), seed=1)
    args = config_from_dict(dict(SMALL, tpu=dict(SMALL["tpu"],
                                                 upload_quant="none")))
    pre = PreprocessConfig.from_transforms(args.transforms, sweep_k=17)
    enc_sd, dec_sd = state_dicts_from_jax(enc_p, dec_p)
    engine = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                             device="cpu")
    pts, val = frames(5)
    d, dv, pv = extract_sequence(Encoder.from_config(args), enc_sd,
                                 [CPU] * 2, engine.coor_scale, pts, val,
                                 preprocess_cfg=pre, batch_per_device=2)
    # two batches of two devices, two scans a share
    assert served == [2] * 4
    d_ref, dv_ref, pv_ref = engine.extract(pts, val)
    assert d.shape[0] == 5 and not pv.all() and pv.any()
    np.testing.assert_allclose(d, d_ref, atol=2e-5)
    np.testing.assert_array_equal(dv, dv_ref)
    np.testing.assert_array_equal(pv, pv_ref)
