"""The port's spans (deeppointmap_tpu_torch/utils/timer.py) on the CPU: a
span enters no profiler range unless a profiler records; totals are
inclusive and per thread; a SlamSystem frame hands its spans to the
ResultLogger and a Trainer step writes them into its steps.jsonl row; the
benchmark's readers of them (benchmark/metrics) give the right value and
None where the program records no spans; and under the benchmark's
spans-only profiler the program's `dpm.*` ranges are recorded and leave
its device readings alone.
"""

import json
import os
import threading
import time

import pytest
import torch

from benchmark.lib import scans
from benchmark.lib import spec
from benchmark.lib import trace as btrace
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
from deeppointmap_tpu_torch.pipeline import infer
from deeppointmap_tpu_torch.pipeline import train as ttrain
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import SlamSystem
from deeppointmap_tpu_torch.utils import timer
from tests.test_torch_mt import WEIGHTS, _wait, demo_config, write_world
from tests.test_torch_trainer import tiny_cfg
from tests.test_trainer import make_synthetic_dataset

yaml = pytest.importorskip("yaml")
torch.set_num_threads(2)

SLAM_READERS = {"slam.odometry_ms_per_frame": "slam.odometry",
                "engine.wait_ms_per_frame": "engine.wait",
                "engine.solve_ms_per_frame": "kabsch.solve"}
TRAIN_READERS = {"train.read_ms_per_step": "train.read",
                 "train.transform_ms_per_step": "train.transform",
                 "train.assemble_ms_per_step": "train.assemble",
                 "train.sync_wait_ms_per_step": "train.sync"}
TRAIN_SPANS = set(TRAIN_READERS.values())
N_FRAMES = 4


class _CountingRange:
    """Stands in for torch.profiler.record_function and counts entries."""
    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------------ the module
def test_no_profiler_no_range(monkeypatch):
    """Without a profiler recording, neither a span nor a scope enters
    record_function, inside a scope or outside; with one, each does."""
    monkeypatch.setattr(_CountingRange, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    with timer.span("outside"):
        pass
    with timer.scope("frame", 1):
        for _ in range(3):
            with timer.span("inside"):
                pass
    assert _CountingRange.entered == 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with timer.scope("frame", 2):
            with timer.span("inside"):
                pass
    assert _CountingRange.entered == 2


def test_nested_spans_inclusive_and_self():
    """A span's total includes the spans inside it; its self time is the
    total less its children's; spans of one name sum over the scope."""
    with timer.scope("step", 7) as tally:
        with timer.span("outer"):
            time.sleep(0.02)
            for _ in range(2):
                with timer.span("inner"):
                    time.sleep(0.01)
    assert set(tally) == {"outer", "inner"}
    assert tally["inner"] >= 0.02
    assert tally["outer"] - tally["inner"] >= 0.02     # outer's self time


def test_outside_a_scope_and_nested_scopes():
    """A span with no scope open records nothing; an inner scope holds
    its own spans and gives the outer one back when it closes."""
    with timer.span("nowhere"):
        pass
    with timer.scope("outer") as outer:
        with timer.span("a"):
            pass
        with timer.scope("inner") as inner:
            with timer.span("b"):
                pass
        with timer.span("c"):
            pass
    with timer.span("nowhere"):
        pass
    assert set(outer) == {"a", "c"} and set(inner) == {"b"}


def test_threads_keep_their_scopes_apart():
    """Two threads' scopes collect their own spans only, and a thread with
    no scope adds nothing to another thread's open scope."""
    barrier = threading.Barrier(3, timeout=30)
    tallies = {}

    def scoped(name):
        with timer.scope(name) as tally:
            barrier.wait()
            for _ in range(50):
                with timer.span(name):
                    pass
            barrier.wait()
        tallies[name] = tally

    def unscoped():
        barrier.wait()
        for _ in range(50):
            with timer.span("loose"):
                pass
        barrier.wait()

    threads = [threading.Thread(target=scoped, args=(n,)) for n in "ab"]
    threads.append(threading.Thread(target=unscoped))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert set(tallies["a"]) == {"a"} and set(tallies["b"]) == {"b"}


def test_count_inside_a_scope_only():
    """`count` adds 1 a call under its name to the scope open on its
    thread, beside the spans' seconds; outside a scope it adds nothing;
    another thread's counts stay in that thread's scope."""
    timer.count("nowhere")
    with timer.scope("frame", 1) as tally:
        for _ in range(3):
            timer.count("engine.graph.replay")
        timer.count("engine.graph.eager")
        with timer.span("inside"):
            pass
        other = {}

        def counted():
            timer.count("engine.graph.replay")        # no scope: nothing
            with timer.scope("frame", 2) as t:
                timer.count("engine.graph.eager")
            other.update(t)
        th = threading.Thread(target=counted)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    timer.count("nowhere")
    assert tally["engine.graph.replay"] == 3
    assert tally["engine.graph.eager"] == 1
    assert set(tally) == {"engine.graph.replay", "engine.graph.eager",
                          "inside"}
    assert other == {"engine.graph.eager": 1}


# --------------------------------------------------------------- the SLAM
@pytest.fixture(scope="module")
def demo_cfg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trace_seq") / "seq")
    write_world(root, n_frames=N_FRAMES, frames_per_lap=96)
    return demo_config(root, str(tmp_path_factory.mktemp("trace_out")))


def _system(cfg):
    args = config_from_dict(cfg)
    engine = InferenceEngine(args, *load_msgpack_weights(WEIGHTS),
                             preprocess_cfg=infer.device_preprocess_config(
                                 args), device="cpu")
    agent = BasicAgent(root=cfg["infer_src"][0], reader="auto")
    agent.set_independent(infer.make_infer_transform(args))
    system = SlamSystem(args, engine, system_id=1,
                        logger_dir=cfg["infer_tgt"])
    return system, agent


def test_slam_frames_record_their_spans(demo_cfg):
    """Each frame with a candidate records slam.odometry, engine.wait and
    kabsch.solve once, under their names; the frame without one records
    extract (and its extraction's eager call, utils/graphs.py); the
    sequential `odometer` record is gone; each frame's engine waits and
    solves lie inside its spans' totals."""
    system, agent = _system(demo_cfg)
    frames = []
    orig = system.result_logger.record_perf

    def record_perf(name, seconds):
        frames[-1][name] = seconds
        orig(name, seconds)
    system.result_logger.record_perf = record_perf
    for i in range(N_FRAMES):
        frames.append({})
        system.step(agent[i])
    assert set(frames[0]) == {"extract", "engine.wait", "engine.graph.eager"}
    for f in frames[1:]:
        assert {"slam.odometry", "engine.wait", "kabsch.solve",
                "mapping"} <= set(f), sorted(f)
        assert "extract" not in f and "odometer" not in f
        assert f["slam.odometry"] + f["mapping"] \
            + f.get("loop_closure", 0.0) >= f["engine.wait"]
    times = system.result_logger.time_recorder
    assert len(times["slam.odometry"]) == N_FRAMES - 1
    assert len(times["engine.wait"]) == N_FRAMES
    assert "odometer" not in times


def test_cpu_frames_count_eager_programs(demo_cfg):
    """On the CPU every extraction and registration runs eagerly: a frame
    counts `engine.graph.eager` once for each (the first frame's lone
    extraction, then at least the odometry step's two) and never
    `engine.graph.replay`; the engine and the decoder capture nothing."""
    system, agent = _system(demo_cfg)
    frames = []
    orig = system.result_logger.record_perf

    def record_perf(name, seconds):
        frames[-1][name] = seconds
        orig(name, seconds)
    system.result_logger.record_perf = record_perf
    for i in range(N_FRAMES):
        frames.append({})
        system.step(agent[i])
    assert frames[0]["engine.graph.eager"] == 1
    for f in frames[1:]:
        assert f["engine.graph.eager"] >= 2
        assert isinstance(f["engine.graph.eager"], int)
    assert not any("engine.graph.replay" in f for f in frames)
    assert len(system.engine._graphs) == 0
    assert len(system.engine.decoder._graphs) == 0


def test_pipelined_threads_accumulate_nothing(demo_cfg):
    """The pipelined mode's stage threads open no scope: their records
    stay the stage timers, and no span lands among them."""
    system, agent = _system(demo_cfg)
    system.MT_Init()
    for i in range(N_FRAMES):
        system.MT_Step(agent[i])
    system.MT_Done()
    _wait(system)
    stages = set(system.result_logger.time_recorder)
    assert {"to_device", "odometer", "mapping"} <= stages
    assert not stages & {"slam.odometry", "engine.wait", "kabsch.solve"}


# -------------------------------------------------------------- training
def _train_rows(tmp_path, num_workers: int) -> list:
    """steps.jsonl of both stages through the CLI on the tiny config."""
    root = str(tmp_path / "ds")
    make_synthetic_dataset(root, n_frames=8)
    out = str(tmp_path / "log")
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(tiny_cfg(root, out)))
    ttrain.main(["--yaml_file", str(path), "--device", "cpu",
                 "--num_workers", str(num_workers)])
    with open(os.path.join(out, "steps.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    assert {r["stage"] for r in rows} == {1, 2}
    for r in rows:
        spans = r["spans"]
        assert set(spans) >= TRAIN_SPANS, sorted(spans)
        assert all(v > 0 for v in spans.values())
        assert spans["train.sync"] <= r["step_s"]
    return rows


def test_trainer_rows_carry_their_spans(tmp_path):
    """Every steps.jsonl row of both stages carries `spans` with the four
    training spans; on the serial path (`num_workers` 0) reads, transforms
    and assembly lie inside the row's batch_s, and the sync inside its
    step_s."""
    for r in _train_rows(tmp_path, 0):
        spans = r["spans"]
        host = spans["train.read"] + spans["train.transform"] \
            + spans["train.assemble"]
        assert host <= r["batch_s"] and r["batch_ready"] is False


def test_trainer_rows_carry_producer_spans(tmp_path):
    """With a batch producer (the CLI's default `num_workers`) every row
    still carries the four spans, the host ones timed in the producer for
    that batch, and says whether its batch was waiting."""
    rows = _train_rows(tmp_path, 4)
    assert all(isinstance(r["batch_ready"], bool) for r in rows)
    assert any(r["batch_ready"] for r in rows)


# --------------------------------------------------- the benchmark readers
def _read(name, rec):
    return spec.metric_reader(name).read(rec)


@pytest.mark.parametrize("metric", sorted(SLAM_READERS))
def test_slam_readers(metric):
    """ms a frame from the window's summed records, None on the parent's
    records (no such span) and outside the SLAM cell."""
    span = SLAM_READERS[metric]
    rec = dict(driver="slam", frames=8,
               stage_s={"mapping": 0.4, "loop_closure": 0.3, span: 0.2})
    assert _read(metric, rec) == pytest.approx(25.0)
    parent = dict(rec, stage_s={"mapping": 0.4, "loop_closure": 0.3,
                                "extract": 0.6, "odometer": 0.01})
    assert _read(metric, parent) is None
    assert _read(metric, dict(rec, driver="train")) is None
    assert _read(metric, {}) is None


def test_graph_replay_share_reader():
    """engine.graph_replay_share: 100 x replays / (replays + eager calls)
    from the window's summed counts; None on the parent's records (no
    counts), with no call at all, and outside the SLAM cell."""
    metric = "engine.graph_replay_share"
    rec = dict(driver="slam", frames=8,
               stage_s={"mapping": 0.4, "engine.graph.replay": 57,
                        "engine.graph.eager": 3})
    assert _read(metric, rec) == pytest.approx(95.0)
    only_eager = dict(rec, stage_s={"engine.graph.eager": 12})
    assert _read(metric, only_eager) == pytest.approx(0.0)
    parent = dict(rec, stage_s={"mapping": 0.4, "kabsch.solve": 0.2})
    assert _read(metric, parent) is None
    assert _read(metric, dict(rec, stage_s={"engine.graph.replay": 0,
                                            "engine.graph.eager": 0})) is None
    assert _read(metric, dict(rec, driver="train")) is None
    assert _read(metric, {}) is None


def _write_steps(cache, rows):
    os.makedirs(os.path.join(cache, "train_out"), exist_ok=True)
    with open(os.path.join(cache, "train_out", "steps.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("metric", sorted(TRAIN_READERS))
def test_train_readers(metric, tmp_path, monkeypatch):
    """Mean ms a step over the window's rows (the run of rows whose
    batch_s are the driver's), None on the parent's rows (no `spans`),
    on rows that are not the window's, and without a steps file."""
    monkeypatch.setattr(scans, "CACHE", str(tmp_path))
    span = TRAIN_READERS[metric]
    spans = lambda v: {n: (v if n == span else 0.5) for n in TRAIN_SPANS}
    rows = [dict(step=i + 1, batch_s=0.1 + i, spans=spans(0.001 * (i + 1)))
            for i in range(6)]
    rec = dict(driver="train", steps=3, batch_s=[3.1, 4.1, 5.1])
    assert _read(metric, rec) is None          # no steps file yet
    _write_steps(str(tmp_path), rows)
    assert _read(metric, rec) == pytest.approx(5.0)    # steps 4-6
    assert _read(metric, dict(rec, batch_s=[3.1, 5.1])) is None
    assert _read(metric, dict(rec, driver="slam")) is None
    _write_steps(str(tmp_path), [{k: v for k, v in r.items()
                                  if k != "spans"} for r in rows])
    assert _read(metric, rec) is None


# ------------------------------------------------- under the benchmark's
def _traced(with_spans: bool) -> dict:
    prof = btrace.profiler()
    with prof:
        with btrace.span("window", True):
            for i in range(3):
                with timer.scope("slam.frame", i) if with_spans \
                        else btrace.span("frame", True):
                    x = torch.randn(64, 64)
                    for _ in range(4):
                        if with_spans:
                            with timer.span("kabsch.solve"):
                                x = x @ x.T / 64
                        else:
                            x = x @ x.T / 64
    names = [e.name() for e in prof.kineto_results.events()]
    return dict(btrace.summarize(prof), names=names)


def test_dpm_ranges_under_the_benchmark_profiler():
    """The benchmark's spans-only profiler records the program's `dpm.*`
    ranges (a scope's and its spans'); they count as host events, not
    launches, and leave the device readings as they are without them."""
    bare, spanned = _traced(False), _traced(True)
    assert spanned["names"].count("dpm.slam.frame") == 3
    assert spanned["names"].count("dpm.kabsch.solve") == 12
    assert not any(n.startswith("dpm.") for n in bare["names"])
    assert spanned["host_events"] > bare["host_events"]
    for key in ("launches", "kernel_s", "device_ops"):
        assert spanned[key] == bare[key], key
    assert all(not label.startswith("dpm.")
               for label, _ in spanned["idle_gaps"])
