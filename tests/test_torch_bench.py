"""bench_torch.py, the port's benchmark, on the CPU at tiny sizes: the
throughput block (two frames, two trials; and the engine mode), the last
line's keys, a failed block gives an `error` line and exit 1 with nothing
retried, `--mode engine` is never entered after a failed `mt` run, and
asking for CUDA without it fails the same way. The full-width warm-up
(`_prepare`) runs once for the module; the accuracy and scale blocks are
tests/test_torch_bench_blocks.py."""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch as bt  # noqa: E402

torch.set_num_threads(2)

LINE_KEYS = {"metric", "value", "unit", "trials", "keyframes", "frames",
             "mode", "accuracy", "scale", "device"}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def prepared(work):
    """_prepare at full width: sample.yaml's engine with the trained
    weights, two frames of the stream, bench.py's warm-up."""
    return bt._prepare("cpu", work, 2)


@pytest.fixture(scope="module")
def mt(prepared, work):
    """The throughput block, mode mt, at two trials."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bt, "_prepare", lambda *a: prepared)
        return bt.throughput("cpu", work, frames=2, trials=2)


def _last_line(capsys, policy="unchanged") -> dict:
    """The JSON line, after the one line that names the matmul policy (the
    tpu.bf16 rule's: float32 on the CPU), which a run without a device
    (`policy` None) does not print."""
    out = capsys.readouterr().out.strip().splitlines()
    assert out[:-1] == ([f"matmul_policy: {policy}"] if policy else []), out
    return json.loads(out[-1])


def test_prepare_warms_up_on_the_stream(prepared):
    args, engine, items, cand = prepared
    assert len(items) == 2 and engine.device.type == "cpu"
    assert args.tpu.encoder_points == 16384
    assert list(args.encoder.npoint) == [4096, 1024, 256, 64, 16]
    assert items[0][0].shape == (1, 16384, 3)
    desc, desc_valid, pts, pts_valid = cand
    assert bool(desc_valid.any()) and pts.shape == (16384, 3)


def test_throughput_block_mt(mt):
    res = mt
    assert res["mode"] == "mt" and res["frames"] == 2
    assert len(res["trials"]) == 2 and min(res["trials"]) > 0
    assert len(res["keyframes"]) == 2 and min(res["keyframes"]) >= 1
    # the median of the unrounded rates, each trial rounded to 3 places
    assert abs(res["value"] - float(np.median(res["trials"]))) <= 1e-3


def test_throughput_block_engine_mode(prepared, work, monkeypatch):
    monkeypatch.setattr(bt, "_prepare", lambda *a: prepared)
    res = bt.throughput("cpu", work, mode="engine", frames=2,
                        engine_iters=1)
    assert res["mode"] == "engine" and res["trials"] is None
    assert res["keyframes"] is None
    assert res["value"] > 0


def test_main_prints_one_line_with_the_keys(mt, work, monkeypatch, capsys):
    """main over the three blocks (throughput's result from the module's
    run; the accuracy and scale blocks' keys stand in for theirs), each
    block's stdout kept off the line."""
    accuracy = dict(ate_m=1.0, ate_no_loop_m=2.0, loop_edges=1,
                    model="full_size_B",
                    demo=dict(ate_m=0.5, ate_no_loop_m=0.7, loop_edges=1))
    scale = dict(frames=6, ate_m=0.1, loop_edges=0, loop_floor_ok=False)

    def block(res):
        def run(device, w, *mode):
            print("chatter")
            return res
        return run

    monkeypatch.setattr(bt, "throughput", block(mt))
    monkeypatch.setattr(bt, "accuracy", block(accuracy))
    monkeypatch.setattr(bt, "scale", block(scale))
    assert bt.main(["--device", "cpu", "--out", work]) == 0
    line = _last_line(capsys)
    assert set(line) == LINE_KEYS
    assert line["metric"] == "scans_per_sec_odometry"
    assert line["unit"] == "scans/s" and line["value"] == mt["value"] > 0
    assert line["trials"] == mt["trials"] and line["device"] == "cpu"
    assert line["accuracy"] == accuracy and line["scale"] == scale


def test_a_failed_block_gives_an_error_line(work, monkeypatch, capsys):
    calls = []

    def broken(device, w):
        calls.append(device)
        raise RuntimeError("boom")

    monkeypatch.setattr(bt, "scale", broken)
    assert bt.main(["--blocks", "scale", "--device", "cpu", "--out",
                    work]) == 1
    line = _last_line(capsys)
    assert line["error"] == "scale: RuntimeError: boom"
    assert line["value"] == 0.0 and "scale" not in line
    assert calls == ["cpu"]


def test_engine_mode_is_never_entered_after_a_failed_mt(work, monkeypatch,
                                                        capsys):
    entered = []

    def failed_trials(*a, **kw):
        raise RuntimeError("mt failed")

    monkeypatch.setattr(bt, "_prepare",
                        lambda *a: (None, None, [None] * 3, None))
    monkeypatch.setattr(bt, "_mt_trials", failed_trials)
    monkeypatch.setattr(bt, "_engine_loop",
                        lambda *a, **kw: entered.append(a) or 1.0)
    assert bt.main(["--blocks", "throughput", "--device", "cpu", "--out",
                    work]) == 1
    line = _last_line(capsys)
    assert line["error"] == "throughput: RuntimeError: mt failed"
    assert line["value"] == 0.0 and line["trials"] is None
    assert entered == []


def test_cuda_asked_for_without_it(work, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    ran = []
    monkeypatch.setattr(bt, "scale", lambda *a: ran.append(a) or {})
    assert bt.main(["--blocks", "scale", "--out", work]) == 1
    line = _last_line(capsys, policy=None)
    assert line["error"].startswith("device: RuntimeError")
    assert "CUDA is not available" in line["error"] and ran == []


def test_unknown_block_is_refused():
    with pytest.raises(SystemExit):
        bt.main(["--blocks", "throughput,latency", "--device", "cpu"])
