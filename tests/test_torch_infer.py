"""The port's CLI options of this slice on the CPU, from temporary YAML
files with test_torch_slam.py's small model and random weights:
`multi_thread` through `pipeline.infer.main`, `tpu.sequence_parallel: 2`
on CPU engines against the sequential run (the JAX package's
tests/test_infer_cli.py rule: the same trajectory files within 1e-5), and
`--profile` writing a Chrome trace.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.utils.timer import TRACE_FILE, Timer
from tests.test_torch_slam import slam_config, write_sequence

yaml = pytest.importorskip("yaml")
torch.set_num_threads(2)


def _write_yaml(tmp_path, name: str, seqs, **top) -> str:
    cfg = slam_config(tmp_path)
    cfg.pop("weight")
    cfg["multi_thread"] = False
    cfg["infer_src"] = [str(s) for s in seqs]
    cfg["infer_tgt"] = str(tmp_path / name)
    tpu = top.pop("tpu", {})
    cfg["tpu"].update(tpu)
    cfg.update(top)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _rows(out, seq: str) -> np.ndarray:
    return np.loadtxt(out / seq / "trajectory.allframes.txt", ndmin=2)


def test_multi_thread_through_main(tmp_path):
    """`multi_thread: true` runs the pipelined SlamSystem from the CLI and
    writes the result tree, every frame accounted for."""
    seq = tmp_path / "seq"
    write_sequence(str(seq), n=4)
    tinfer.main(["--yaml_file", _write_yaml(tmp_path, "out", [seq],
                                            multi_thread=True),
                 "--device", "cpu"])
    rows = _rows(tmp_path / "out", "Seq00")
    assert rows.shape == (4, 12) and np.isfinite(rows).all()
    assert (tmp_path / "out" / "Seq00" / "trajectory.pg.g2o").exists()


def test_sequence_parallel_matches_sequential(tmp_path):
    """Two sequences on two CPU engines at once give the trajectories of
    one engine running them in turn."""
    seqs = [tmp_path / "seqA", tmp_path / "seqB"]
    write_sequence(str(seqs[0]), n=3)
    write_sequence(str(seqs[1]), n=5)
    tinfer.main(["--yaml_file", _write_yaml(tmp_path, "out_seq", seqs),
                 "--device", "cpu"])
    tinfer.main(["--yaml_file", _write_yaml(
        tmp_path, "out_par", seqs, tpu=dict(sequence_parallel=2)),
        "--device", "cpu"])
    for s, n in (("Seq00", 3), ("Seq01", 5)):
        a, b = _rows(tmp_path / "out_seq", s), _rows(tmp_path / "out_par", s)
        assert a.shape == (n, 12)
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_parallel_engines_count(tmp_path, monkeypatch):
    """`run_sequences_parallel` makes min(streams, devices) engines: with
    --device cpu as many as asked for, each with its own share."""
    made, ran = [], []

    def make(args, states, dev):
        made.append(SimpleNamespace(device=torch.device(dev)))
        return made[-1]

    monkeypatch.setattr(tinfer, "_make_engine", make)
    monkeypatch.setattr(tinfer, "run_sequence",
                        lambda args, eng, seq, out, system_id=1:
                        ran.append(([id(m) for m in made].index(id(eng)),
                                    seq)))
    from deeppointmap_tpu_torch.config import config_from_dict

    args = config_from_dict(slam_config(tmp_path), device="cpu",
                            infer_tgt=str(tmp_path))
    seqs = [(i, f"s{i}") for i in range(5)]
    assert tinfer.run_sequences_parallel(args, None, seqs, 3) == 3
    assert len(made) == 3
    assert sorted(ran) == [(0, "s0"), (0, "s3"), (1, "s1"), (1, "s4"),
                           (2, "s2")]


def test_profile_writes_a_trace(tmp_path):
    """`--profile` writes <infer_tgt>/profile/trace.json, a Chrome trace
    with the run's operator events in it."""
    seq = tmp_path / "seq"
    write_sequence(str(seq), n=2)
    tinfer.main(["--yaml_file", _write_yaml(tmp_path, "out", [seq]),
                 "--device", "cpu", "--profile"])
    trace = tmp_path / "out" / "profile" / TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert _rows(tmp_path / "out", "Seq00").shape == (2, 12)


def test_timer_records_sections():
    t = Timer()
    for _ in range(3):
        with t.record("a"):
            pass
    assert len(t.times["a"]) == 3 and t.mean("a") >= 0.0
    assert set(t.summary()) == {"a"}
    t.reset()
    assert t.summary() == {}
