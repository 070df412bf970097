"""`tpu.encoder_bf16`: the port's encoder with its feature path in bfloat16
against the JAX encoder's, on the CPU.

Both packages gate the option to their accelerator (the JAX encoder to
the TPU at trace time, the port's to a CUDA device in
`models.encoder.activation_dtype`), so both gates are forced here: the
port's by patching that one function, the JAX package's by giving its
encoder module a `jax` whose `default_backend()` says "tpu" and which
forwards everything else. A global patch of `jax.default_backend`, as
tests/test_encoder_bf16.py makes, would also switch the JAX reference's
FPS to its Pallas kernel and its top-k to the approximate one.

The same parameters (the JAX package's init with every LayerNorm scale
and every bias perturbed, seeded, as trained weights are: at the init's
scale 1 and bias 0 a scale or bias rounded to bfloat16 changes nothing)
and the same inputs (numpy, seeded) at tests/test_encoder_bf16.py's tiny
shapes, carried across by state_dict_from_flax.

The bfloat16 reference is the Flax module applied op by op, each rounding
where Flax writes it. Under `jax.jit` XLA keeps bfloat16 intermediates of a
fusion in float32 (`xla_allow_excess_precision`, on by default): with the
perturbed parameters the jitted run leaves only 60-62% of the features
bit-equal to the op-by-op one, and with that flag off the two are equal.
Measured gap between the port and the op-by-op reference on seeds 0-2:
bit for bit on two, 99.98% of the features bit-equal and the largest
difference 7.7e-8 of the feature scale on the third (one rounding flipped
by the order of a float32 sum). A cast point moved as the likely mistakes
move it (`F.layer_norm` on bfloat16 scale and bias, or the bias added
before the rounding) leaves 55-63% of the features bit-equal and
differences of 1.2e-2 of scale, as large as bfloat16 against float32.
Stated tolerance: at least 99.9% of the features bit-equal and the largest
difference at most 1e-6 of the scale. The two roundings are also held
against Flax's `Dense` and `LayerNorm` directly, bit for bit.
"""

import copy
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.data.dataset import SlamDatasets as JSlamDatasets
from deeppointmap_tpu.data.transforms import (PointCloudTransforms as
                                              JTransforms)
from deeppointmap_tpu.models import encoder as enc_mod
from deeppointmap_tpu.models.decoder import Decoder as JDecoder
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.pipeline.trainer import Trainer as JTrainer
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import SlamDatasets
from deeppointmap_tpu_torch.models import common as tcommon
from deeppointmap_tpu_torch.models import encoder as tenc
from deeppointmap_tpu_torch.models.weights import (state_dict_from_flax,
                                                   state_dicts_from_jax)
from deeppointmap_tpu_torch.pipeline.train import training_transforms
from deeppointmap_tpu_torch.pipeline.trainer import Trainer
from tests.test_trainer import make_synthetic_dataset, train_args

torch.set_num_threads(2)

TINY = dict(npoint=(64, 16), radius_list=((0.2, 0.4), (0.4, 0.8)),
            nsample_list=((8, 8), (8, 8)), in_channel=3, out_channel=32,
            width=8, upsample_layers=1)


class _TpuJax:
    """`jax` as the JAX encoder module sees it on a TPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def _force_port_bf16(act_dtype, device):
    return torch.bfloat16 if act_dtype == "bfloat16" else torch.float32


@pytest.fixture
def forced(monkeypatch):
    """Both packages' gates forced to bfloat16 for this test."""
    monkeypatch.setattr(enc_mod, "jax", _TpuJax())
    monkeypatch.setattr(tenc, "activation_dtype", _force_port_bf16)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.4, (2, 256, 3)).astype(np.float32)
    return pts, rng.random((2, 256)) > 0.1


def _perturbed(params, seed):
    """`params` with every LayerNorm scale scaled by 1 + 0.3 N(0, 1) and
    every bias shifted by 0.1 N(0, 1)."""
    rng = np.random.default_rng(100 + seed)

    def perturb(path, x):
        name = getattr(path[-1], "key", "")
        x = np.asarray(x)
        if name == "scale":
            x = x * (1 + 0.3 * rng.standard_normal(x.shape))
        elif name == "bias":
            x = x + 0.1 * rng.standard_normal(x.shape)
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(perturb, params)


def _jax_encode(act, params, pts, valid):
    """The JAX encoder; bfloat16 op by op (no jit), float32 jitted."""
    apply = enc_mod.Encoder(**TINY, act_dtype=act).apply
    if act == "float32":
        apply = jax.jit(apply)
    out = apply(params, jnp.asarray(pts), jnp.asarray(valid))
    return tuple(np.asarray(x) for x in out)


def _port_encode(act, params, pts, valid):
    enc = tenc.Encoder(**TINY, act_dtype=act)
    enc.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        out = enc(torch.from_numpy(pts), torch.from_numpy(valid))
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forced_bf16_matches_jax_bf16(forced, seed):
    pts, valid = _inputs(seed)
    params = _perturbed(jax.jit(enc_mod.Encoder(**TINY).init)(
        jax.random.PRNGKey(seed), jnp.asarray(pts), jnp.asarray(valid)), seed)
    jc32, jf32, jv32 = _jax_encode("float32", params, pts, valid)
    jc, jf, jv = _jax_encode("bfloat16", params, pts, valid)
    tc, tf, tv = _port_encode("bfloat16", params, pts, valid)
    # the geometry is the float32 run's, in both packages
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc32)
    np.testing.assert_array_equal(tv, jv32)
    assert tf.dtype == np.float32 and tf.shape == jf.shape
    assert not np.array_equal(jf, jf32)      # the JAX side is bfloat16
    scale = np.abs(jf32).max()
    err = np.abs(tf - jf)
    assert (err == 0).mean() >= 0.999, (err == 0).mean()
    assert err.max() <= 1e-6 * scale, err.max() / scale


@pytest.mark.parametrize("seed", [0, 1])
def test_roundings_match_flax_dense_and_layer_norm(seed):
    """`linear_bf16` and `layer_norm_bf16` against Flax's `Dense` and
    `LayerNorm` with dtype=bfloat16, float32 parameters, bit for bit; the
    obvious PyTorch spellings (`F.layer_norm` on bfloat16, the bias added
    before the rounding) do not match."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (512, 24)).astype(np.float32)
    dense = fnn.Dense(40, dtype=jnp.bfloat16)
    dp = _perturbed(dense.init(jax.random.PRNGKey(seed), x), seed)
    norm = fnn.LayerNorm(epsilon=tcommon.LN_EPS, dtype=jnp.bfloat16)
    y = np.array(dense.apply(dp, x).astype(jnp.float32))
    np_ = _perturbed(norm.init(jax.random.PRNGKey(seed), y), seed)
    z = np.asarray(norm.apply(np_, y).astype(jnp.float32))
    lin = torch.nn.Linear(24, 40)
    ln = torch.nn.LayerNorm(40, eps=tcommon.LN_EPS)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.array(dp["params"]["kernel"]).T))
        lin.bias.copy_(torch.from_numpy(np.array(dp["params"]["bias"])))
        ln.weight.copy_(torch.from_numpy(np.array(np_["params"]["scale"])))
        ln.bias.copy_(torch.from_numpy(np.array(np_["params"]["bias"])))
        ty = tcommon.linear_bf16(lin, torch.from_numpy(x))
        tz = tcommon.layer_norm_bf16(ln, torch.from_numpy(y).bfloat16())
        bf = torch.bfloat16
        naive_y = (F.linear(torch.from_numpy(x).to(bf).float(),
                            lin.weight.to(bf).float())
                   + lin.bias.to(bf).float()).to(bf)
        naive_z = F.layer_norm(torch.from_numpy(y).to(bf), (40,),
                               ln.weight.to(bf), ln.bias.to(bf), ln.eps)
    assert ty.dtype == tz.dtype == bf
    np.testing.assert_array_equal(ty.float().numpy(), y)
    np.testing.assert_array_equal(tz.float().numpy(), z)
    assert not np.array_equal(naive_y.float().numpy(), y)
    assert not np.array_equal(naive_z.float().numpy(), z)


@pytest.mark.parametrize("value", [True, False, None])
def test_from_config_agrees_with_jax(value):
    base = dict(npoint=[64, 16], radius_list=[[0.2, 0.4], [0.4, 0.8]],
                nsample_list=[[8, 8], [8, 8]], in_channel=3,
                out_channel=32, width=8, expansion=4, upsample_layers=1,
                sample=[{"type": "fps"}])
    tpu = {} if value is None else dict(encoder_bf16=value)
    want = enc_mod.Encoder.from_config(
        JConfig(dict(encoder=dict(base), tpu=tpu))).act_dtype
    got = tenc.Encoder.from_config(
        config_from_dict(dict(encoder=dict(base), tpu=tpu))).act_dtype
    assert got == want == ("bfloat16" if value else "float32")


def test_cpu_gate_gives_float32_bit_for_bit():
    """Without the forced gate the option changes nothing on the CPU; on a
    CUDA device the gate gives bfloat16 (a device object, no card
    needed)."""
    pts, valid = _inputs(3)
    params = jax.jit(enc_mod.Encoder(**TINY).init)(
        jax.random.PRNGKey(3), jnp.asarray(pts), jnp.asarray(valid))
    for got, want in zip(_port_encode("bfloat16", params, pts, valid),
                         _port_encode("float32", params, pts, valid)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert tenc.activation_dtype("bfloat16", cpu) == torch.float32
    assert tenc.activation_dtype("float32", cuda) == torch.float32
    assert tenc.activation_dtype("bfloat16", cuda) == torch.bfloat16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bf16_ds"))
    make_synthetic_dataset(root, n_frames=8)
    return root


def _config(root, tmp_path, name: str, bf16: bool) -> dict:
    cfg = json.loads(json.dumps(train_args(root)))
    cfg["train"]["registration"]["optimizer"] = dict(type="sgd",
                                                     kwargs=dict(lr=1e-2))
    cfg["tpu"]["data_parallel"] = 1
    cfg["tpu"]["encoder_bf16"] = bf16
    cfg["infer_tgt"] = str(tmp_path / name)
    return cfg


@pytest.fixture(scope="module")
def params(root, tmp_path_factory):
    """The JAX package's initial parameters of the training config."""
    cfg = _config(root, tmp_path_factory.mktemp("init"), "init", False)
    return init_params(JConfig(cfg), seed=7)[2:]


def _step(root, tmp_path, params, pkg: str, bf16: bool) -> float:
    """One stage-1 SGD step of `pkg`'s Trainer (the option reaching the
    encoder through Encoder.from_config) -> its loss."""
    cfg = _config(root, tmp_path, f"{pkg}_{bf16}", bf16)
    rng = np.random.default_rng(0)
    jargs = JConfig(copy.deepcopy(cfg))
    ep, dp = params
    if pkg == "jax":
        enc, dec = (cls.from_config(jargs) for cls in (enc_mod.Encoder,
                                                       JDecoder))
        tfs = JTransforms(jargs, mode="train", rng=rng)
        tfs.transforms.transforms = tfs.transforms.transforms[:-1]
        t = JTrainer(jargs, JSlamDatasets(jargs, data_transforms=tfs,
                                          rng=rng), enc, dec, ep, dp, rng=rng)
        assert t.encoder.act_dtype == ("bfloat16" if bf16 else "float32")
    else:
        args = config_from_dict(cfg)
        ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                          rng=rng)
        t = Trainer(args, ds, *state_dicts_from_jax(ep, dp), rng=rng,
                    device="cpu")
        assert t.encoder.act_dtype == ("bfloat16" if bf16 else "float32")
    t.stage = 1
    t._setup_stage()
    batch = next(t._iter_batches())
    if pkg == "jax":
        t.state, m = t.train_step(t.state, batch)
        return float(m["loss"])
    m = t.train_step(batch)
    # parameters stay float32; only the activations are bfloat16
    assert all(p.dtype == torch.float32 for p in t.encoder.parameters())
    return float(m["loss"])


def test_bf16_training_step(forced, root, params, tmp_path):
    """One small stage-1 step under bfloat16: finite, within 2e-2 of the
    float32 step's loss, and equal to the JAX package's bfloat16 step
    (relerr <= 1e-4; the float32 steps agree to 1e-5,
    tests/test_torch_train_step.py)."""
    loss32 = _step(root, tmp_path, params, "torch", False)
    loss16 = _step(root, tmp_path, params, "torch", True)
    jloss16 = _step(root, tmp_path, params, "jax", True)
    assert np.isfinite(loss16) and np.isfinite(loss32)
    assert loss16 != loss32
    assert abs(loss16 - loss32) <= 2e-2 * abs(loss32)
    assert abs(loss16 - jloss16) <= 1e-4 * abs(jloss16), (loss16, jloss16)
