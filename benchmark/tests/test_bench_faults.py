"""The harness, on the CPU at a small size (benchmark/tests/tiny.py),
with the timed path sound and then broken underneath: `correct` is true,
then false for each fault the cell can have. The look for a card is
skipped (`allow_cpu`); everything else is a run's."""

import functools
import json

import pytest
import torch

from benchmark import run


def _run(tiny_bench, capsys, workload, seed=20261018, seconds=3):
    dst, bench = tiny_bench
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", "0"],
                  allow_cpu=True, root=dst, bench=bench)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_slam_sound_run_is_correct(tiny_bench, capsys):
    res = _run(tiny_bench, capsys, "slam_loop2")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert list(res)[-1] == "checks"


def _shift_upload(monkeypatch):
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    orig = InferenceEngine._dequant_input

    def shifted(self, points, valid):
        pts, v = orig(self, points, valid)
        return pts + 0.01, v
    monkeypatch.setattr(InferenceEngine, "_dequant_input", shifted)


def _scale_features(monkeypatch):
    from deeppointmap_tpu_torch.models.encoder import Encoder

    orig = Encoder.forward

    def scaled(self, *a, **kw):
        c, f, v = orig(self, *a, **kw)
        return c, f * 1.05, v
    monkeypatch.setattr(Encoder, "forward", scaled)


def _move_answer(monkeypatch):
    from deeppointmap_tpu_torch.models.decoder import Decoder

    orig = Decoder.registration

    def moved(self, *a, **kw):
        R, t, conf, rmse, n = orig(self, *a, **kw)
        return R, t + 0.5, conf, rmse, n
    monkeypatch.setattr(Decoder, "registration", moved)


def _move_answer_of(entry):
    """The answer moved only in the registrations that one engine entry
    runs (scan-to-map, or map-to-map): the other kinds stay sound."""
    def fault(monkeypatch):
        from deeppointmap_tpu_torch.models.decoder import Decoder
        from deeppointmap_tpu_torch.slam.engine import InferenceEngine

        inside = []
        orig_entry = getattr(InferenceEngine, entry)
        orig_reg = Decoder.registration

        @functools.wraps(orig_entry)
        def flagged(self, *a, **kw):
            inside.append(1)
            try:
                return orig_entry(self, *a, **kw)
            finally:
                inside.pop()

        def moved(self, *a, **kw):
            R, t, conf, rmse, n = orig_reg(self, *a, **kw)
            return (R, t + 0.5, conf, rmse, n) if inside else \
                (R, t, conf, rmse, n)
        monkeypatch.setattr(InferenceEngine, entry, flagged)
        monkeypatch.setattr(Decoder, "registration", moved)
    fault.__name__ = f"_move_answer_of_{entry}"
    return fault


def _stale_frame(monkeypatch):
    """Every other frame the system is fed the frame before it again."""
    from deeppointmap_tpu_torch.slam.system import SlamSystem

    orig = SlamSystem.step
    last = {}

    def stale(self, data):
        prev = last.get(id(self))
        last[id(self)] = data
        n = getattr(self, "_fault_n", 0)
        self._fault_n = n + 1
        return orig(self, prev if (prev is not None and n % 2) else data)
    monkeypatch.setattr(SlamSystem, "step", stale)


def _shift_tile_member(monkeypatch):
    """A map tile assembled with its members' poses 5 cm off."""
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    orig = InferenceEngine._pad_members

    def shifted(self, members, centering):
        members, poses, mvalid = orig(self, members, centering)
        poses = poses.copy()
        poses[:, 0, 3] += 0.05
        return members, poses, mvalid
    monkeypatch.setattr(InferenceEngine, "_pad_members", shifted)


@pytest.mark.parametrize("fault", [
    _shift_upload, _scale_features, _move_answer,
    _move_answer_of("register_scan_to_map_with_info_async"),
    _move_answer_of("register_map_to_map_with_info_async"),
    _stale_frame, _shift_tile_member], ids=lambda f: f.__name__)
def test_slam_fault_is_not_correct(tiny_bench, capsys, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tiny_bench, capsys, "slam_loop2")
    assert not res["correct"], res["checks"]


def test_train_sound_run_is_correct(tiny_bench, capsys):
    res = _run(tiny_bench, capsys, "train_reg_b4", seconds=2)
    assert res["correct"], res["checks"]


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from deeppointmap_tpu_torch.pipeline.trainer import Trainer

    orig = Trainer.train_step

    def half(self, batch):
        return orig(self, type(batch)(*(x[:max(len(x) // 2, 1)]
                                        for x in batch)))
    monkeypatch.setattr(Trainer, "train_step", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_train_fault_is_not_correct(tiny_bench, capsys, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tiny_bench, capsys, "train_reg_b4", seconds=2)
    assert not res["correct"], res["checks"]
