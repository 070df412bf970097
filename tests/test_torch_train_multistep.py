"""Many training steps of the port against the JAX package's, through both
Trainers, from the same parameters over the same batches: 16 stage-1
steps with AdamW and the cosine schedule across a `mult_epoch` boundary
where the curriculum's K grows from 2 to 4, then 4 stage-2 steps with Adam
(the recipe's optimizers; scripts/train_full_size.py full_train_args).

The trainers' loops are driven as `Trainer.run` drives them (the stage
switch, the fresh optimizer at stage 2, the epoch that sets K); the
batches of both samplers must be equal byte for byte. Tolerances: every
step's loss relerr <= 1e-4; after the last step, the parameters of every
layer within a relative Frobenius error ||port - jax|| / ||jax|| <= 1e-3.
A layer's parameters are taken as one tensor, its affine map [weight |
bias] (LayerNorm: [scale | bias]): the biases start at zero and move at
most ~lr a step, so a bias alone has no scale of its own to be relative
to (measured alone, a few encoder biases read up to 1e-2, against 1e-4
for their layers). The key third of each attention's `in_proj_bias` is
compared apart: its gradient is zero in exact arithmetic (softmax over the
keys is invariant to adding q.b_k to every logit), so Adam, which
normalizes each entry's gradient, moves it on rounding noise alone in
both packages; the test holds that gradient to <= 1e-5 of the query
third's and the entries within the schedule's total step. This holds the
optimizer states' drift over many steps, which the first-step tests of
tests/test_torch_train_step.py do not.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.data.dataset import SlamDatasets as JSlamDatasets
from deeppointmap_tpu.data.transforms import (PointCloudTransforms as
                                              JTransforms)
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.pipeline.trainer import Trainer as JTrainer
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import SlamDatasets
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.pipeline.train import training_transforms
from deeppointmap_tpu_torch.pipeline.trainer import Trainer
from tests.test_trainer import make_synthetic_dataset, train_args

torch.set_num_threads(2)

LOSS_RELERR = 1e-4
PARAM_RELERR = 1e-3
KEY_GRAD_SHARE = 1e-5
STAGE1_EPOCHS, STAGE2_EPOCHS = 2, 1


def config(root: str) -> dict:
    cfg = json.loads(json.dumps(train_args(root)))
    reg, loop = cfg["train"]["registration"], cfg["train"]["loop_detection"]
    reg.update(num_epochs=STAGE1_EPOCHS, K=2, K_0=2, K_mult=2, mult_epoch=1,
               K_max=4, optimizer=dict(type="adamw", kwargs=dict(lr=1e-3)),
               scheduler=dict(type="cosine", kwargs=dict(eta_min=1e-5)))
    loop.update(num_epochs=STAGE2_EPOCHS, batch_size=2,
                optimizer=dict(type="adam", kwargs=dict(lr=1e-3)),
                scheduler=dict(type="cosine", kwargs=dict(eta_min=1e-5)))
    cfg["tpu"]["data_parallel"] = 1
    return cfg


def build(root, tmp_path):
    cfg = config(root)
    rng = np.random.default_rng(0)
    args = JConfig(dict(cfg, infer_tgt=str(tmp_path / "jax")))
    tfs = JTransforms(args, mode="train", rng=rng)
    tfs.transforms.transforms = tfs.transforms.transforms[:-1]
    enc, dec, ep, dp = init_params(args, seed=7)
    jt = JTrainer(args, JSlamDatasets(args, data_transforms=tfs, rng=rng),
                  enc, dec, ep, dp, rng=rng)
    rng = np.random.default_rng(0)
    args = config_from_dict(dict(cfg, infer_tgt=str(tmp_path / "torch")))
    tt = Trainer(args, SlamDatasets(args, data_transforms=training_transforms(
        args, rng), rng=rng), *state_dicts_from_jax(ep, dp), rng=rng,
        device="cpu")
    return jt, tt


def frob_relerr(got: torch.Tensor, want: torch.Tensor) -> float:
    d = float(torch.linalg.vector_norm(got.double() - want.double()))
    return d / float(torch.linalg.vector_norm(want.double()))


def layers(sd: dict) -> dict:
    """A state dict -> {layer: its parameters flattened into one tensor},
    the key third of every in_proj_bias under a name of its own."""
    out = {}
    for name, t in sorted(sd.items()):
        layer, leaf = name.rsplit(".", 1)
        t = t.detach().cpu().ravel()
        if leaf == "in_proj_bias":
            c = t.numel() // 3
            out[f"{layer}.key_bias"] = [t[c:2 * c]]
            t = torch.cat([t[:c], t[2 * c:]])
        out.setdefault(layer, []).append(t)
    return {k: torch.cat(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both trainers through every step -> (per-step losses and frames,
    the port trainer, the JAX trainer)."""
    root = str(tmp_path_factory.mktemp("multistep_ds"))
    make_synthetic_dataset(root, n_frames=8)
    jt, tt = build(root, tmp_path_factory.mktemp("multistep_out"))
    steps, last = [], None
    for epoch in range(STAGE1_EPOCHS + STAGE2_EPOCHS):
        if jt.stage == 1 and epoch >= STAGE1_EPOCHS:
            jt.stage = tt.stage = 2
            jt._params = (jt.state.enc_params, jt.state.dec_params)
            jt._setup_stage()
            tt._setup_stage()
        jt.epoch = tt.epoch = epoch
        for jb, tb in zip(jt._iter_batches(), tt._iter_batches(),
                          strict=True):
            for f in jb._fields:
                assert np.asarray(getattr(tb, f)).tobytes() == \
                    np.asarray(getattr(jb, f)).tobytes(), (epoch, f)
            jt.state, jm = jt.train_step(jt.state, jb)
            tm = tt.train_step(tb)
            if tt.stage == 1:
                last = tb
            steps.append(dict(stage=tt.stage, epoch=epoch,
                              frames=int(np.asarray(tb[0]).shape[0]),
                              jax=float(jm["loss"]), port=float(tm["loss"])))
    yield steps, tt, jt, last
    tt.close()


def test_steps_span_the_curriculum(run):
    """>= 8 stage-1 steps over a K boundary (the frames a step change),
    then >= 4 stage-2 steps."""
    steps, tt, _, _ = run
    s1 = [s for s in steps if s["stage"] == 1]
    s2 = [s for s in steps if s["stage"] == 2]
    assert len(s1) >= 8 and len(s2) >= 4
    assert {s["epoch"] for s in s1} == {0, 1}
    assert tt._curriculum_K() == 4
    tt.epoch = 0
    assert tt._curriculum_K() == 2


@pytest.mark.parametrize("stage", [1, 2])
def test_every_steps_loss_matches_jax(run, stage):
    steps, _, _, _ = run
    errs = [abs(s["port"] - s["jax"]) / abs(s["jax"]) for s in steps
            if s["stage"] == stage]
    assert max(errs) <= LOSS_RELERR, errs


def _jax_state_dicts(jt):
    return state_dicts_from_jax(
        jax.tree.map(np.asarray, jt.state.enc_params),
        jax.tree.map(np.asarray, jt.state.dec_params))


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_parameters_after_the_last_step_match_jax(run, part):
    _, tt, jt, _ = run
    jenc, jdec = _jax_state_dicts(jt)
    model, want = (tt.encoder, jenc) if part == "encoder" else \
        (tt.decoder, jdec)
    got, want = layers(model.state_dict()), layers(want)
    assert got.keys() == want.keys()
    errs = {k: frob_relerr(got[k], want[k]) for k in want
            if not k.endswith("key_bias")}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= PARAM_RELERR, (worst, errs[worst])


def test_attention_key_bias_moves_on_noise_alone(run):
    """The key third of in_proj_bias: a zero gradient up to rounding on
    the last stage-1 batch, and entries within the total of the learning
    rates both schedules stepped (Adam moves an entry <= ~lr a step)."""
    from deeppointmap_tpu_torch.models.loss import LossConfig
    from deeppointmap_tpu_torch.parallel.train_step import (
        registration_metrics, to_device)

    steps, tt, jt, batch = run
    for p in tt.decoder.parameters():
        p.requires_grad_(True)
        p.grad = None
    m = registration_metrics(tt.encoder, tt.decoder,
                             LossConfig.from_args(tt.args),
                             to_device(batch, "cpu"), max_pairs=64)
    m["loss"].backward()
    budget = 1.1e-3 * len(steps)
    _, jdec = _jax_state_dicts(jt)
    n = 0
    for name, p in tt.decoder.named_parameters():
        if not name.endswith("in_proj_bias"):
            continue
        c = p.numel() // 3
        g = p.grad.detach()
        assert float(g[c:2 * c].norm()) <= KEY_GRAD_SHARE * float(
            g[:c].norm()), name
        for b in (p.detach()[c:2 * c], jdec[name][c:2 * c]):
            assert float(b.abs().max()) <= budget, name
        n += 1
    assert n == 2 * int(tt.args.decoder.attention_layers)


