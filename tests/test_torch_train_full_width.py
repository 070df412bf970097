"""One stage-1 SGD step at DeepPointMap-B full width (configs/infer/
sample.yaml's trees, 16384-point pad) with the trained weights
artifacts/full_size_occ_v2, the port against the JAX package on the CPU,
on a two-frame batch of chip_smoke.py's training scene.

Tolerances: every metric relerr <= 1e-5 (top1_acc included: both
packages count a prediction into the other map group's token slots, which
are invalid as destinations, as a miss); the update (the gradient times
the learning rate) ||d|| / ||update|| <= 1e-3 over all parameters and
<= 5e-2 for each tensor. Measured: 2.2e-4 overall, 1.3e-2 for the worst
tensor. The encoder's backward alone agrees to 4e-7 and the gradient that
the decoder and the loss send into the descriptors to 3e-5; sums with
heavy cancellation (a tensor's gradient over 2 x 4096 groups of 32) raise
that float32 noise to the per-tensor figures, so the tiny config's
elementwise check (tests/test_torch_train_step.py) does not carry over.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

import chip_smoke as cs
from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.config import TPU_DEFAULTS as J_TPU_DEFAULTS
from deeppointmap_tpu.models.loss import LossConfig as JLossConfig
from deeppointmap_tpu.parallel.train_step import (RegistrationBatch as
                                                  JBatch)
from deeppointmap_tpu.parallel.train_step import (TrainState,
                                                  make_registration_train_step)
from deeppointmap_tpu.pipeline.common import load_weights
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data import synthetic as syn
from deeppointmap_tpu_torch.data.dataset import SlamDatasets
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.pipeline.batching import build_registration_batch
from deeppointmap_tpu_torch.pipeline.train import training_transforms
from deeppointmap_tpu_torch.pipeline.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, cs.WEIGHTS)
LR = 1e-2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The first 6 frames of the train scene, the full-width train config
    (one map group of S = 2: two frames) and the batch of item 3."""
    torch.set_num_threads(4)
    root = str(tmp_path_factory.mktemp("full_train"))
    scene = dict(cs.TRAIN_SCENE)
    try:
        cs.TRAIN_SCENE["frames"] = 6
        cs.render_train_scene(syn, root)
    finally:
        cs.TRAIN_SCENE.update(scene)
    cfg = cs.train_config(root, str(tmp_path_factory.mktemp("full_log")))
    cfg["train"]["registration"].update(
        fill=False, optimizer=dict(type="sgd", kwargs=dict(lr=LR)))
    args = config_from_dict(cfg)
    rng = np.random.default_rng(1)
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    ds.forced_S = 2
    batch = build_registration_batch(*ds[3], args.train.registration,
                                     cs.N_PAD, rng)
    assert batch.points.shape[:2] == (1, 2) and batch.valid.sum() > 8000
    return cfg, args, ds, batch


def test_full_width_step_matches_jax(setup):
    cfg, args, ds, batch = setup
    jargs = JConfig(cfg)
    tpu = JConfig(J_TPU_DEFAULTS)
    tpu.update(cfg["tpu"])
    jargs.tpu = tpu
    enc, dec, ep, dp = load_weights(jargs, WEIGHTS)
    opt = optax.sgd(LR)
    step = jax.jit(make_registration_train_step(
        enc, dec, JLossConfig.from_args(jargs), opt, 60.0, 1024))
    state, jm = step(TrainState(ep, dp, opt.init((ep, dp)), np.int32(0)),
                     JBatch(*batch))
    jenc, jdec = state_dicts_from_jax(jax.tree.map(np.asarray,
                                                   state.enc_params),
                                      jax.tree.map(np.asarray,
                                                   state.dec_params))

    trainer = Trainer(args, ds, *state_dicts_from_jax(ep, dp),
                      device="cpu")
    tm = trainer.train_step(batch)
    trainer.close()
    for k, v in jm.items():
        v = float(v)
        assert abs(tm[k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, tm[k], v)
    before = state_dicts_from_jax(jax.tree.map(np.asarray, ep),
                                  jax.tree.map(np.asarray, dp))
    rel, diff2, upd2 = {}, 0.0, 0.0
    for part, want, start in (("encoder", jenc, before[0]),
                              ("decoder", jdec, before[1])):
        got = getattr(trainer, part).state_dict()
        for k, w in want.items():
            upd = (w - start[k]).double()
            if float(upd.norm()) == 0.0:
                assert torch.equal(got[k], w), f"{part}.{k}"
                continue
            d = (got[k] - w).double()
            rel[f"{part}.{k}"] = float(d.norm() / upd.norm())
            diff2 += float(d.norm()) ** 2
            upd2 += float(upd.norm()) ** 2
    assert (diff2 / upd2) ** 0.5 <= 1e-3
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 5e-2, (worst, rel[worst])
