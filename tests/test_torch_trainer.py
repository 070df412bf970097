"""The port's Trainer and its CLI on the CPU: both stages through
`pipeline.train.main --device cpu`, the metrics schema of the JAX package's
tests/test_trainer.py, the batches of whole epochs equal byte for byte to
the JAX Trainer's (curriculum K, one S per global batch, the epoch's
permutation), the stage-2 freeze (bit for bit), checkpoint resume
mid-stage (optimizer state restored) and at the stage boundary (afresh),
and weights_final.msgpack read back by the JAX package's load_weights
(equal trees) and run by the port's pipeline/infer.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.data.dataset import SlamDatasets as JSlamDatasets
from deeppointmap_tpu.data.transforms import (PointCloudTransforms as
                                              JTransforms)
from deeppointmap_tpu.pipeline.common import init_params, load_weights
from deeppointmap_tpu.pipeline.trainer import Trainer as JTrainer
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import SlamDatasets
from deeppointmap_tpu_torch.models.weights import (flax_tree_from_state_dict,
                                                   state_dicts_from_jax)
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.pipeline import train as ttrain
from deeppointmap_tpu_torch.pipeline.train import training_transforms
from deeppointmap_tpu_torch.pipeline.trainer import Trainer, newest_checkpoint
from tests.test_torch_slam import slam_config, write_sequence
from tests.test_trainer import make_synthetic_dataset, train_args

yaml = pytest.importorskip("yaml")
torch.set_num_threads(2)


def tiny_cfg(root: str, out: str, **train) -> dict:
    """tests/test_trainer.py's config as a plain dict."""
    cfg = json.loads(json.dumps(train_args(root)))
    cfg["infer_tgt"] = out
    cfg["train"].update(train)
    return cfg


def port_trainer(cfg: dict, seed: int = 0, params_seed: int = 7):
    args = config_from_dict(copy.deepcopy(cfg))
    rng = np.random.default_rng(seed)
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    _, _, ep, dp = init_params(JConfig(copy.deepcopy(cfg)), seed=params_seed)
    return Trainer(args, ds, *state_dicts_from_jax(ep, dp), rng=rng,
                   device="cpu")


def snapshot(t: Trainer) -> dict:
    return {f"{part}.{k}": v.detach().clone()
            for part, m in (("encoder", t.encoder), ("decoder", t.decoder))
            for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer_ds"))
    make_synthetic_dataset(root, n_frames=8)
    return root


def test_two_stages_through_main(root, tmp_path):
    """Both stages from the CLI: metrics.jsonl per stage with the JAX
    package's keys, steps.jsonl a line a step, checkpoints/ pruned to
    keep_checkpoints, and weights_final.msgpack equal, as a tree, to what
    the JAX package's load_weights reads from it."""
    out = str(tmp_path / "log")
    cfg = tiny_cfg(root, out, save_cycle=1, keep_checkpoints=1)
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = ttrain.main(["--yaml_file", str(path), "--device", "cpu"])
    assert trainer.stage == 2 and trainer.epoch == 2
    assert trainer.step == 8 + 4        # 8 frames: 8 items, then 4 pairs
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    common = {"epoch", "step", "stage", "sec_per_step"}
    keys = {1: common | {"loss", "loss_pairing", "loss_coarse",
                         "loss_offset", "top1_acc"},
            2: common | {"loss", "acc", "precision", "recall", "fp"}}
    assert {int(x["stage"]) for x in lines} == {1, 2}
    for x in lines:
        assert set(x) == keys[int(x["stage"])], sorted(x)
        assert all(np.isfinite(v) for v in x.values())
    with open(os.path.join(out, "steps.jsonl")) as f:
        steps = [json.loads(x) for x in f]
    assert [s["step"] for s in steps] == list(range(1, 13))
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == \
        ["checkpoint_ep2.pt"]
    assert os.path.exists(os.path.join(out, "source_snapshot.zip"))

    wpath = os.path.join(out, "weights_final.msgpack")
    _, _, ep, dp = load_weights(JConfig(cfg), wpath)
    for tree, model in ((ep, trainer.encoder), (dp, trainer.decoder)):
        want = flax_tree_from_state_dict(model.state_dict())
        got = jax.tree.map(np.asarray, tree["params"])
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_trained_weights_run_in_port_infer(root, tmp_path):
    """weights_final.msgpack of a run drives pipeline/infer.main."""
    out = str(tmp_path / "log")
    cfg = tiny_cfg(root, out)
    cfg["train"]["loop_detection"]["num_epochs"] = 0
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ttrain.main(["--yaml_file", str(path), "--device", "cpu"])
    seq = tmp_path / "seq"
    write_sequence(str(seq), n=3)
    icfg = slam_config(tmp_path)
    for tree in ("encoder", "decoder", "loss"):
        icfg[tree] = cfg[tree]
    icfg.update(weight=os.path.join(out, "weights_final.msgpack"),
                multi_thread=False, infer_src=[str(seq)],
                infer_tgt=str(tmp_path / "infer"))
    icfg["tpu"].update(encoder_points=2048, reg_buckets=[64, 128],
                       sweep_reuse=False)
    ipath = tmp_path / "infer.yaml"
    ipath.write_text(yaml.safe_dump(icfg))
    tinfer.main(["--yaml_file", str(ipath), "--device", "cpu"])
    rows = np.loadtxt(tmp_path / "infer" / "Seq00" / "trajectory.allframes.txt",
                      ndmin=2)
    assert rows.shape[1] == 12 and len(rows) >= 1 and np.isfinite(rows).all()


def test_epochs_of_batches_match_jax(root, tmp_path):
    """Two stage-1 epochs with the curriculum growing K (K_0 2 -> 4 at
    epoch 1) and batch_size 2, then a stage-2 epoch: every batch equal to
    the JAX Trainer's from the same seed."""
    cfg = tiny_cfg(root, str(tmp_path / "t"))
    cfg["train"]["registration"].update(num_epochs=2, batch_size=2,
                                        mult_epoch=1, K_0=2, K_max=4)
    cfg["tpu"]["data_parallel"] = 1
    jcfg = copy.deepcopy(cfg)
    jcfg["infer_tgt"] = str(tmp_path / "j")
    jargs, jrng = JConfig(jcfg), np.random.default_rng(0)
    jtfs = JTransforms(jargs, mode="train", rng=jrng)
    jtfs.transforms.transforms = jtfs.transforms.transforms[:-1]
    enc, dec, ep, dp = init_params(jargs, seed=7)
    jt = JTrainer(jargs, JSlamDatasets(jargs, data_transforms=jtfs, rng=jrng),
                  enc, dec, ep, dp, rng=jrng)
    tt = port_trainer(cfg)
    shapes = set()
    for epoch, stage in ((0, 1), (1, 1), (2, 2)):
        for t in (jt, tt):
            t.epoch, t.stage = epoch, stage
            if stage == 2:
                t._setup_stage()
        assert tt._curriculum_K() == jt._curriculum_K()
        jb, tb = list(jt._iter_batches()), list(tt._iter_batches())
        assert len(tb) == len(jb) == tt._steps_per_epoch()
        for a, b in zip(tb, jb):
            for f in b._fields:
                x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
            shapes.add(a[0].shape[:2])
    assert len(shapes) >= 3       # S = 2 (B = 4) in epoch 0; S = 3, 4 later


def test_stage2_freezes_backbone(root, tmp_path):
    """Stage 2 leaves the encoder and every non-loop decoder module bit for
    bit unchanged and trains the loop head."""
    t = port_trainer(tiny_cfg(root, str(tmp_path / "log")), params_seed=2)
    before = snapshot(t)
    t.stage = 2
    t._setup_stage()
    t._steps_per_epoch = lambda: 3
    t.train_one_epoch()
    after = snapshot(t)
    loop = [k for k in before if k.startswith("decoder.loop")]
    assert loop and any(not torch.equal(before[k], after[k]) for k in loop)
    for k in before:
        if not k.startswith("decoder.loop"):
            assert torch.equal(before[k], after[k]), k
    assert {id(p) for g in t.optimizer.param_groups for p in g["params"]} \
        == {id(p) for n, p in t.decoder.named_parameters()
            if n.startswith("loop")}


def test_resume_mid_stage_and_at_the_boundary(root, tmp_path):
    """A checkpoint inside stage 1 restores the optimizer and schedule
    state; one at the stage boundary (epoch == stage-1 epochs) starts the
    optimizer afresh, and the run goes on into stage 2. A checkpoints
    directory resumes from its newest file."""
    cfg = tiny_cfg(root, str(tmp_path / "a"), save_cycle=100)
    cfg["train"]["registration"].update(
        num_epochs=2, optimizer=dict(type="adamw", kwargs=dict(lr=1e-4)),
        scheduler=dict(type="cosine", kwargs=dict(eta_min=0.0)))
    a = port_trainer(cfg)
    a._steps_per_epoch = lambda: 2
    a._setup_stage()
    a.train_one_epoch()
    a.epoch = 1
    a.save()                                   # mid-stage
    ckpt_dir = os.path.join(a.log_dir, "checkpoints")

    b = port_trainer(dict(cfg, infer_tgt=str(tmp_path / "b")),
                     params_seed=99)
    b._steps_per_epoch = lambda: 2
    b.load_checkpoint(ckpt_dir)
    assert (b.epoch, b.step, b.stage) == (1, 2, 1)
    for k, v in snapshot(a).items():
        assert torch.equal(v, snapshot(b)[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert len(sb["state"]) == len(sa["state"]) > 0
    for i in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])
    assert b.scheduler.last_epoch == a.scheduler.last_epoch == 2
    assert b.optimizer.param_groups[0]["lr"] == \
        a.optimizer.param_groups[0]["lr"]
    b.train_one_epoch()
    assert b.step == 4

    a.epoch = 2
    a.save()                                   # the stage boundary
    assert newest_checkpoint(ckpt_dir).endswith("checkpoint_ep2.pt")
    c = port_trainer(dict(cfg, infer_tgt=str(tmp_path / "c")))
    c._steps_per_epoch = lambda: 1
    c.load_checkpoint(ckpt_dir)
    assert (c.epoch, c.stage) == (2, 1)
    assert c.optimizer.state_dict()["state"] == {}
    assert c.scheduler.last_epoch == 0
    c.run()
    assert c.stage == 2 and c.epoch == 3
    assert os.path.exists(os.path.join(c.log_dir, "weights_final.msgpack"))


def test_train_yamls_load(root, tmp_path, monkeypatch):
    """configs/train/example.yaml and scripts/train_full_size.py's
    full_train_args tree load through the port's CLI config, training keys
    included; `tpu.encoder_bf16: true` (refused before this slice) reaches
    the encoder of full_train_args's tree, and training runs with it
    through main (float32 on the CPU, by the encoder's gate)."""
    from deeppointmap_tpu_torch.models import encoder as tenc

    from deeppointmap_tpu_torch.config import load_config
    from scripts.train_full_size import full_train_args

    args = load_config(["--yaml_file", "configs/train/example.yaml"])
    assert args.train.registration.K_max == 8 and args.tpu.remat is False
    assert args.tpu.data_parallel == "auto" and args.checkpoint == ""
    tree = json.loads(json.dumps(full_train_args("/r", str(tmp_path / "o"),
                                                 remat=True)))
    path = tmp_path / "full.yaml"
    path.write_text(yaml.safe_dump(tree))
    args = load_config(["--yaml_file", str(path), "--device", "cpu"])
    assert args.tpu.remat is True and args.train.save_cycle == 4
    assert args.train.log_cycle == 25 and args.encoder.npoint[0] == 4096
    tree["tpu"]["encoder_bf16"] = True
    path.write_text(yaml.safe_dump(tree))
    args = load_config(["--yaml_file", str(path), "--device", "cpu"])
    assert tenc.Encoder.from_config(args).act_dtype == "bfloat16"

    seen = set()
    gate = tenc.activation_dtype

    def spy(act_dtype, device):
        seen.add((act_dtype, device.type))
        return gate(act_dtype, device)

    monkeypatch.setattr(tenc, "activation_dtype", spy)
    out = str(tmp_path / "bf16")
    cfg = tiny_cfg(root, out)
    cfg["tpu"]["encoder_bf16"] = True
    path.write_text(yaml.safe_dump(cfg))
    t = ttrain.main(["--yaml_file", str(path), "--device", "cpu"])
    assert t.encoder.act_dtype == "bfloat16"
    assert seen == {("bfloat16", "cpu")}
    assert os.path.exists(os.path.join(t.log_dir, "weights_final.msgpack"))


def _bare_trainer(cfg: dict, seed: int = 0) -> Trainer:
    """port_trainer with the port's own initial weights (the batch tests
    never step)."""
    from deeppointmap_tpu_torch.models.decoder import Decoder
    from deeppointmap_tpu_torch.models.encoder import Encoder

    args = config_from_dict(copy.deepcopy(cfg))
    rng = np.random.default_rng(seed)
    ds = SlamDatasets(args, data_transforms=training_transforms(args, rng),
                      rng=rng)
    return Trainer(args, ds, Encoder.from_config(args).state_dict(),
                   Decoder.from_config(args).state_dict(), rng=rng,
                   device="cpu")


def _recording(t: Trainer, raise_at=None):
    """Replace `t.train_step` by one that keeps each batch handed to it
    and, at call `raise_at`, raises out of the epoch."""
    seen = []

    def step(batch):
        seen.append(batch)
        if raise_at is not None and len(seen) == raise_at:
            raise KeyboardInterrupt
        return {"loss": 0.0}

    t.train_step = step
    return seen


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a) is type(b)
        for f in b._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f


def _producer_cfg(root, out, chain):
    cfg = tiny_cfg(root, out)
    cfg["train"]["registration"].update(num_epochs=2, batch_size=2,
                                        mult_epoch=1, K_0=2, K_max=4)
    cfg["tpu"]["data_parallel"] = 1
    if chain == "random_rt":
        cfg["transforms"] = {"RandomRT": {"r_std": 0.5, "t_std": 1.0},
                             **cfg["transforms"]}
    return cfg


@pytest.mark.parametrize("chain", ["plain", "random_rt"])
@pytest.mark.parametrize("num_workers", [1, 2])
def test_producer_batches_match_serial(root, tmp_path, monkeypatch,
                                       num_workers, chain):
    """With `num_workers` the batches handed to train_step come from the
    producer process and equal, field by field and byte for byte, the
    serial path's from the same seed: two stage-1 epochs with the
    curriculum raising K, then a stage-2 epoch; with a chain that draws
    (RandomRT: the frames load serially in the producer) and one that
    does not (in two loader processes when there are two). Every step's
    row says whether its batch was waiting and carries the producer's
    spans."""
    from deeppointmap_tpu_torch.pipeline import producer

    monkeypatch.setattr(producer, "WAIT_S", 30.0)
    serial = _bare_trainer(_producer_cfg(root, str(tmp_path / "s"), chain))
    cfg = _producer_cfg(root, str(tmp_path / "p"), chain)
    cfg["num_workers"] = num_workers
    made = _bare_trainer(cfg)
    assert serial._producer is None and made._producer is not None
    want, got = _recording(serial), _recording(made)
    try:
        for epoch, stage in ((0, 1), (1, 1), (2, 2)):
            for t in (serial, made):
                t.epoch, t.stage = epoch, stage
                if stage == 2:
                    t._setup_stage()
                t.train_one_epoch()
        _assert_same_batches(got, want)
        assert len({b[0].shape[:2] for b in got}) >= 3
        assert made._producer.cuda_initialized is False
    finally:
        made.close()
        serial.close()
    with open(tmp_path / "p" / "steps.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == len(got)
    assert all(isinstance(r["batch_ready"], bool) for r in rows)
    for r in rows:
        assert {"train.read", "train.transform",
                "train.assemble"} <= set(r["spans"])
    with open(tmp_path / "s" / "steps.jsonl") as f:
        assert not any(json.loads(line)["batch_ready"] for line in f)


def test_producer_epoch_left_early_and_close(root, tmp_path, monkeypatch):
    """An exception out of train_step after 2 steps leaves the producer
    with batches built ahead; the next epoch gets a fresh plan and exactly
    the serial path's batches, never one of the abandoned epoch's. close()
    stops the producer (a bounded wait), which never initialised CUDA."""
    from deeppointmap_tpu_torch.pipeline import producer

    monkeypatch.setattr(producer, "WAIT_S", 30.0)
    serial = _bare_trainer(_producer_cfg(root, str(tmp_path / "s"), "plain"))
    cfg = _producer_cfg(root, str(tmp_path / "p"), "plain")
    cfg["num_workers"] = 2
    made = _bare_trainer(cfg)
    runs = {}
    try:
        for name, t in (("serial", serial), ("made", made)):
            first = _recording(t, raise_at=3)
            with pytest.raises(KeyboardInterrupt):
                t.train_one_epoch()
            assert len(first) == 3 < t._steps_per_epoch()
            rest = _recording(t)
            t.train_one_epoch()
            t.epoch = 1
            t.train_one_epoch()
            runs[name] = first + rest
        _assert_same_batches(runs["made"], runs["serial"])
        proc = made._producer
        assert proc.cuda_initialized is False and proc._proc.poll() is None
    finally:
        made.close()
        serial.close()
    assert proc._proc.wait(timeout=15) is not None
