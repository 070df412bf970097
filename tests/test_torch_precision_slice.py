"""The slice under the `tpu.bf16` rule: the port's InferenceEngine with the
"bfloat16" policy forced on the CPU against the JAX package's engine run
under the TPU's rule (tests/test_torch_precision.emulate), and one stage-1
training step's loss and gradients against jax.grad under the same rule.

The slice runs the trained demo-width model (artifacts/synthetic_demo,
pipeline/demo.demo_args) on the first two scans of its world, normalized
(the host chain, so both packages encode the same points): extract ->
odometry_step -> register_with_info -> loop_scores, each package
registering its own extraction. Each of the decoder's operations agrees
with its emulation to ~1e-7 on the same inputs (its attention, its MLP,
its LayerNorm), but an operand that rounds to the other bfloat16
neighbour in one package (a float32 ulp apart before the rounding)
spreads through the trained model's sharp attention: one attention layer
of the demo decoder ends ~8e-4 apart in norm where the rule moves it
~2.6e-3 from float32. So the slice is held to the stated tolerances,
each a few times the difference measured (given in each docstring), and
the descriptors also to half the rule's move from float32.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.parallel import train_step as jts
from deeppointmap_tpu.pipeline.common import load_weights as jload_weights
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models.weights import (load_msgpack_weights,
                                                   state_dicts_from_jax)
from deeppointmap_tpu_torch.parallel.train_step import (registration_metrics,
                                                        to_device)
from deeppointmap_tpu_torch.pipeline.demo import padded_scans
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.utils import precision
from tests.test_torch_models import jax_args
from tests.test_torch_mt import WEIGHTS, demo_config
from tests.test_torch_ops import relerr, rotation_deg
from tests.test_torch_precision import emulate, normerr
from tests.test_torch_train_step import root, trainers  # noqa: F401

torch.set_num_threads(2)

#: the JAX engine's jitted programs -> (their function, static arguments)
PROGRAMS = {"_extract_fn": ("_extract_impl", ()),
            "_odometry_fn": ("_odometry_impl", ("num_pairs",)),
            "_reg_info_fn": ("_register_info_impl", ("num_pairs",)),
            "_loop_fn": ("_loop_impl", ())}


@pytest.fixture(scope="module")
def slice_run():
    """{name: (JAX under the rule, port under "bfloat16", port float32)}
    of every output of the slice on two scans."""
    cfg = demo_config("/nonexistent", "/nonexistent")
    jargs = jax_args(cfg)
    enc, dec, enc_p, dec_p = jload_weights(jargs, WEIGHTS)
    j_eng = JEngine(jargs, enc_p, dec_p, encoder=enc, decoder=dec)
    for attr, (impl, static) in PROGRAMS.items():
        setattr(j_eng, attr, emulate(getattr(j_eng, impl), static))
    states = load_msgpack_weights(WEIGHTS)
    engines = [j_eng] + [InferenceEngine(config_from_dict(cfg), *states,
                                         device="cpu", matmul_policy=policy)
                         for policy in (precision.BF16, None)]
    assert engines[2].matmul_policy == precision.UNCHANGED
    pts, valid = padded_scans(60, 2, 2048)
    x = (pts / np.float32(60.0)).astype(np.float32)
    out = {}
    for eng in engines:
        d, dv, pv = eng.extract(x, valid)
        cand = (d[0], dv[0], pts[0], pv[0])
        odo = eng.odometry_step(x[1:2], valid[1:2], *cand)
        reg = eng.register_with_info(d[0], dv[0], d[1], dv[1], pts[0], pv[0],
                                     pts[1], pv[1])
        loop = eng.loop_scores(d[[0, 1]], d[[1, 0]], dv[[0, 1]], dv[[1, 0]])
        for name, value in (("desc", d), ("odo_se3", odo[3]),
                            ("odo_conf", odo[4]), ("odo_rmse", odo[5]),
                            ("odo_info", odo[6]),
                            ("reg_se3", reg[0]), ("reg_conf", reg[1]),
                            ("reg_rmse", reg[2]), ("reg_info", reg[3]),
                            ("loop", loop), ("pv", pv), ("dv", dv)):
            out.setdefault(name, []).append(np.asarray(value))
    return out


def test_descriptors_match_the_tpu_rule(slice_run):
    """The same valid points and tokens; descriptors ||d|| / ||w|| <=
    1e-3 and <= 0.5 of the rule's move from float32 (measured 2.6e-4
    against 1.07e-3)."""
    j, bf, f32 = slice_run["desc"]
    for key in ("pv", "dv"):
        for got in slice_run[key][1:]:
            np.testing.assert_array_equal(got, slice_run[key][0])
    assert normerr(bf, j) <= 1e-3
    assert normerr(bf, j) <= 0.5 * normerr(f32, j)


@pytest.mark.parametrize("prefix", ["odo", "reg"])
def test_poses_and_information_match_the_tpu_rule(slice_run, prefix):
    """The fused odometry step and register_with_info: R within 0.05 deg,
    t within 3 cm, confidence within 3e-3 relative, rmse within 1 cm, the
    information matrix relerr <= 1e-3 (measured: 0.017 deg, 9 mm, 6e-4,
    1.6 mm of 0.40 m, 2.3e-4)."""
    j, bf, _ = slice_run[f"{prefix}_se3"]
    assert rotation_deg(bf[:3, :3], j[:3, :3]) <= 0.05
    assert np.linalg.norm(bf[:3, 3] - j[:3, 3]) <= 3e-2
    conf, rmse = slice_run[f"{prefix}_conf"], slice_run[f"{prefix}_rmse"]
    assert abs(conf[1] - conf[0]) <= 3e-3 * abs(conf[0])
    assert abs(rmse[1] - rmse[0]) <= 1e-2
    info = slice_run[f"{prefix}_info"]
    assert info[0][3, 3] > 0
    assert relerr(info[1], info[0]) <= 1e-3


def test_loop_scores_match_the_tpu_rule(slice_run):
    """Overlap probabilities within 1e-3 (measured 1.8e-4)."""
    j, bf, _ = slice_run["loop"]
    np.testing.assert_allclose(bf, j, rtol=0, atol=1e-3)


def test_training_step_matches_jax_grad_under_the_tpu_rule(root, tmp_path):
    """One stage-1 step's loss and gradients (S = 2, SMALL-like width of
    tests/test_trainer.train_args): the port's models under "bfloat16"
    against jax.grad of the JAX package's own loss under the emulation:
    loss relerr <= 5e-5 and <= 0.1 of float32's; per parameter
    ||d|| / ||g|| <= 2e-2 for >= 95% of the tensors and <= 0.05 for all
    (measured: median 2.9e-3, largest 1.3e-2), and over the whole model
    the squared difference <= 1% of float32's (measured 0.05%)."""
    jt, tt = trainers(root, tmp_path, dict(type="sgd", kwargs=dict(lr=1e-2)),
                      stage=1)
    jb = next(jt._iter_batches())
    step = jts.make_registration_train_step(
        jt.encoder, jt.decoder, jt.loss_cfg, jt.optimizer, jt.coor_scale,
        max_pairs=int(jt.cfg.registration.get("max_pairs", 1024)))
    loss_fn = inspect.getclosurevars(step).nonlocals["loss_fn"]
    params = (jt.state.enc_params, jt.state.dec_params)
    (jloss, _), jgrads = emulate(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jax.tree.map(jnp.asarray, jb))
    want = state_dicts_from_jax({"params": jgrads[0]["params"]},
                                {"params": jgrads[1]["params"]})
    batch = to_device(jb, "cpu")
    got = {}
    for policy in (precision.BF16, precision.HIGHEST):
        for part in (tt.encoder, tt.decoder):
            precision.set_policy(part, policy)
            part.zero_grad(set_to_none=True)
        m = registration_metrics(
            tt.encoder, tt.decoder, tt.loss_cfg, batch, tt.coor_scale,
            int(tt.cfg.registration.get("max_pairs", 1024)))
        m["loss"].backward()
        got[policy] = (float(m["loss"].detach()), [
            {k: p.grad.numpy().copy() for k, p in part.named_parameters()
             if p.grad is not None} for part in (tt.encoder, tt.decoder)])
    tt.close()
    loss_bf, grads_bf = got[precision.BF16]
    loss_32, grads_32 = got[precision.HIGHEST]
    assert relerr(loss_bf, float(jloss)) <= 5e-5
    assert relerr(loss_bf, float(jloss)) <= 0.1 * relerr(loss_32,
                                                         float(jloss))
    errs, d_rule, d_pkg = [], 0.0, 0.0
    for g_bf, g_32, w in zip(grads_bf, grads_32, want):
        for name in set(w) - set(g_bf):     # no gradient in the port
            assert not w[name].numpy().any(), name
        for name, g in g_bf.items():
            ref = w[name].numpy()
            errs.append(normerr(g, ref))
            d_pkg += float(np.sum((g - ref) ** 2))
            d_rule += float(np.sum((g_32[name] - ref) ** 2))
    errs = np.asarray(errs)
    assert np.mean(errs <= 2e-2) >= 0.95 and errs.max() <= 0.05, \
        np.sort(errs)[-5:]
    assert d_pkg <= 0.01 * d_rule
