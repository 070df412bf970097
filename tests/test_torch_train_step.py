"""One training step of each stage in the port against the JAX package's,
through both Trainers, from the same parameters (init_params, converted by
state_dicts_from_jax) and the same batch, which both trainers' samplers
build alike from one seed (equal byte for byte).

Tolerances: the loss relerr <= 1e-5; parameters after one SGD step rtol
2e-4, atol 1e-6 (the JAX package's own data-parallel tolerance,
tests/test_trainer_dp.py); after AdamW's first step every entry within
2 lr (Adam's first update is about +-lr, so an entry whose tiny gradient
changes sign under float32 noise moves 2 lr apart) and >= 99% within 1e-6;
remat on against off loss rtol 1e-6. The schedules equal optax's within
1e-7 of the base learning rate over 3 epochs (optax evaluates the cosine
in float32, the port in float64; near the end of a decay that float32
rounding alone is ~8e-7 of the value), and torch's AdamW / SGD with momentum
equal optax.adamw / optax.sgd (rtol 1e-5, atol 1e-7 over six steps).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.data.dataset import SlamDatasets as JSlamDatasets
from deeppointmap_tpu.data.transforms import (PointCloudTransforms as
                                              JTransforms)
from deeppointmap_tpu.pipeline import train_utils as jtu
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.pipeline.trainer import Trainer as JTrainer
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import SlamDatasets
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.pipeline import train_utils as ttu
from deeppointmap_tpu_torch.pipeline.train import training_transforms
from deeppointmap_tpu_torch.pipeline.trainer import Trainer
from tests.test_trainer import make_synthetic_dataset, train_args

torch.set_num_threads(2)


def relerr(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("step_ds"))
    make_synthetic_dataset(root, n_frames=8)
    return root


def trainers(root, tmp_path, opt: dict, stage: int, seed: int = 0,
             remat: bool = False):
    """(JAX Trainer, port Trainer) on the same config, parameters and
    seed, both at the start of `stage` with a fresh optimizer."""
    cfg = json.loads(json.dumps(train_args(root)))
    for tree in ("registration", "loop_detection"):
        cfg["train"][tree]["optimizer"] = copy.deepcopy(opt)
    cfg["tpu"]["data_parallel"] = 1
    cfg["tpu"]["remat"] = remat
    out = []
    for pkg in ("jax", "torch"):
        c = copy.deepcopy(cfg)
        c["infer_tgt"] = str(tmp_path / pkg)
        rng = np.random.default_rng(seed)
        if pkg == "jax":
            args = JConfig(c)
            tfs = JTransforms(args, mode="train", rng=rng)
            tfs.transforms.transforms = tfs.transforms.transforms[:-1]
            ds = JSlamDatasets(args, data_transforms=tfs, rng=rng)
            enc, dec, ep, dp = init_params(args, seed=7)
            t = JTrainer(args, ds, enc, dec, ep, dp, rng=rng)
        else:
            args = config_from_dict(c)
            ds = SlamDatasets(args, data_transforms=training_transforms(
                args, rng), rng=rng)
            t = Trainer(args, ds, *state_dicts_from_jax(ep, dp), rng=rng,
                        device="cpu")
        t.stage = stage
        t._setup_stage()
        out.append(t)
    return out


def jax_state_dicts(jt):
    return state_dicts_from_jax(jax.tree.map(np.asarray, jt.state.enc_params),
                                jax.tree.map(np.asarray, jt.state.dec_params))


def step_both(jt, tt):
    """One step of each on the first batch of the stage (equal batches)."""
    jb, tb = next(jt._iter_batches()), next(tt._iter_batches())
    for f in jb._fields:
        assert np.asarray(getattr(tb, f)).tobytes() == \
            np.asarray(getattr(jb, f)).tobytes(), f
    before = {k: v.detach().clone() for k, v in
              list(tt.encoder.state_dict().items())
              + [("dec." + k, v) for k, v in tt.decoder.state_dict().items()]}
    jt.state, jm = jt.train_step(jt.state, jb)
    tm = tt.train_step(tb)
    return {k: float(v) for k, v in jm.items()}, tm, before


def params_of(tt, jt):
    """[(name, port tensor, JAX array)] over both models."""
    jenc, jdec = jax_state_dicts(jt)
    out = [(k, v, jenc[k]) for k, v in tt.encoder.state_dict().items()]
    return out + [("dec." + k, v, jdec[k])
                  for k, v in tt.decoder.state_dict().items()]


@pytest.mark.parametrize("stage", [1, 2])
def test_sgd_step_matches_jax(root, tmp_path, stage):
    jt, tt = trainers(root, tmp_path, dict(type="sgd", kwargs=dict(lr=1e-2)),
                      stage)
    jm, tm, before = step_both(jt, tt)
    assert set(tm) == set(jm)
    for k in jm:
        assert relerr(tm[k], jm[k]) <= 1e-5 or abs(tm[k] - jm[k]) <= 1e-7, k
    moved = 0
    for name, got, want in params_of(tt, jt):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=name)
        moved += int(not torch.equal(got, before[name]))
    frozen_loop = stage == 1
    for name, got, _ in params_of(tt, jt):
        trains = ("loop" in name) != frozen_loop
        assert torch.equal(got, before[name]) != trains, name
    assert moved > 0


@pytest.mark.parametrize("stage", [1, 2])
def test_adamw_first_step_matches_jax(root, tmp_path, stage):
    lr = 1e-4
    jt, tt = trainers(root, tmp_path, dict(type="adamw", kwargs=dict(
        lr=lr, weight_decay=1e-2)), stage, seed=3)
    jm, tm, _ = step_both(jt, tt)
    assert relerr(tm["loss"], jm["loss"]) <= 1e-5
    diff = np.concatenate([np.abs(got.numpy().astype(np.float64)
                                  - want.numpy()).ravel()
                           for _, got, want in params_of(tt, jt)])
    assert diff.max() <= 2 * lr, diff.max()
    assert np.mean(diff <= 1e-6) >= 0.99, np.mean(diff <= 1e-6)


def test_remat_matches_no_remat(root, tmp_path):
    """torch.utils.checkpoint around the encoder changes nothing but
    memory: the same loss and the same SGD update."""
    opt = dict(type="sgd", kwargs=dict(lr=1e-2))
    _, off = trainers(root, tmp_path / "off", opt, 1, seed=5)
    _, on = trainers(root, tmp_path / "on", opt, 1, seed=5, remat=True)
    assert on._step.metrics_fn is not None and on.args.tpu.remat
    batch = next(off._iter_batches())
    assert np.array_equal(next(on._iter_batches()).points, batch.points)
    m_off, m_on = off.train_step(batch), on.train_step(batch)
    assert relerr(m_on["loss"], m_off["loss"]) <= 1e-6
    for (k, a), b in zip(on.encoder.state_dict().items(),
                         off.encoder.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=k)


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("kind,kwargs", [
    ("identity", {}), ("cosine", {"eta_min": 1e-5}),
    ("cosine_restart", {"T_0": 1, "eta_min": 1e-5})])
def test_schedules_match_optax(kind, kwargs):
    """Three epochs of 7 steps (one step past the end too): the value at
    every step, and the lr the LambdaLR gives the optimizer at that step."""
    cfg = {"type": kind, "kwargs": kwargs}
    want = jtu.build_schedule(JConfig(cfg), 1e-3, 7, 3)
    got = ttu.build_schedule(config_from_dict(cfg), 1e-3, 7, 3)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = ttu.build_optimizer(config_from_dict(
        {"type": "sgd", "kwargs": {}}), [p], got)
    for i in range(22):
        w = float(want(i))
        assert abs(got(i) - w) <= 1e-7 * 1e-3, (i, got(i), w)
        assert abs(opt.param_groups[0]["lr"] - w) <= 1e-7 * 1e-3, i
        opt.step()
        sched.step()


@pytest.mark.parametrize("kind", ["adamw", "adam", "sgd"])
def test_optimizers_match_optax(kind):
    """torch.optim against the optax transformation the JAX package
    builds, over 6 steps of random gradients under a cosine schedule."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = rng.normal(size=(6, 5, 4)).astype(np.float32)
    kwargs = {"adamw": {"weight_decay": 0.05, "betas": [0.8, 0.99]},
              "adam": {}, "sgd": {"momentum": 0.9}}[kind]
    cfg = {"type": kind, "kwargs": dict(kwargs, lr=1e-2)}
    sched_cfg = {"type": "cosine", "kwargs": {"eta_min": 1e-4}}
    jopt = jtu.build_optimizer(JConfig(cfg), jtu.build_schedule(
        JConfig(sched_cfg), 1e-2, 3, 2))
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = ttu.build_optimizer(config_from_dict(cfg), [p],
                                     ttu.build_schedule(config_from_dict(
                                         sched_cfg), 1e-2, 3, 2))
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-7)
