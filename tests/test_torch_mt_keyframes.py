"""The pipelined SlamSystem's keyframes and exit codes against the JAX
package's, on a harsh stream (~3.3 m a frame, depth 2).

The pipelined mode is held to the reference frame for frame here, where
tests/test_torch_mt.py compares it with the sequential mode by statistics.
`_platform_speed` is pinned on both systems, so both take the same branch
of the staleness fallback at every frame: a high speed keeps the fallback
on (the odometer serializes against mapping), zero keeps it off (candidate
search reads a pose graph up to `depth` frames stale).

With the fallback off, which keyframes a run keeps depends on how far the
odometer runs ahead of mapping. The JAX package's launch returns before
the device has computed (asynchronous dispatch), and so does the port's on
the GPU; on the CPU the port's launch computes eagerly, so mapping catches
up before the next candidate search and the staleness never shows. The
port's CPU engine is therefore driven with its odometry step deferred to
the resolver, which the mapping thread calls: the launch then returns at
once, as on the card. Under that, both branches agree exactly with the JAX
package, and the fallback-off branch keeps fewer keyframes than the
fallback-on one: that is the reference's behaviour, not a fault of the port.
"""

import os

import numpy as np
import pytest
import torch

from deeppointmap_tpu.data.dataset import BasicAgent as JAgent
from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import load_weights
from deeppointmap_tpu.slam import modules as jmodules
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu.slam.system import SlamSystem as JSlam
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.slam import modules as tmodules
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import SlamSystem
from tests.test_torch_mt import WEIGHTS, _wait, demo_config, write_world
from tests.test_torch_slam import jax_config

torch.set_num_threads(2)

N_FRAMES = 24
#: m/frame pinned into _platform_speed: far above the keyframe distance
#: (fallback on from the first frame) or zero (never on)
SPEEDS = {"fallback_on": 1000.0, "fallback_off": 0.0}


@pytest.fixture(scope="module")
def harsh(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mt_kf") / "seq")
    write_world(root, n_frames=N_FRAMES, frames_per_lap=48)
    return demo_config(root, str(tmp_path_factory.mktemp("mt_kf_out")))


def deferred(engine):
    """The engine's odometry launch with its work moved into the resolver,
    so that the launch returns at once, as an asynchronous launch does."""
    launch = engine.odometry_step_async

    def odometry_step_async(*args, **kwargs):
        box = []

        def resolve():
            if not box:
                box.append(launch(*args, **kwargs)())
            return box[0]
        return resolve
    engine.odometry_step_async = odometry_step_async


def run_pipelined(cfg, pkg: str, speed: float, monkeypatch):
    """One pipelined run (depth 2) -> (exit codes in mapping order,
    keyframe timesteps, staleness events)."""
    root = cfg["infer_src"][0]
    os.makedirs(cfg["infer_tgt"], exist_ok=True)
    if pkg == "jax":
        args = jax_config(cfg)
        enc, dec, ep, dp = load_weights(args, WEIGHTS)
        engine = JEngine(args, ep, dp, encoder=enc, decoder=dec,
                         preprocess_cfg=jinfer.device_preprocess_config(args))
        agent = JAgent(root=root, reader="auto")
        agent.set_independent(jinfer.make_infer_transform(args))
        system = JSlam(args, engine, system_id=1,
                       logger_dir=cfg["infer_tgt"])
        mapping = jmodules.MappingModule
    else:
        args = config_from_dict(cfg)
        engine = InferenceEngine(
            args, *load_msgpack_weights(WEIGHTS), device="cpu",
            preprocess_cfg=tinfer.device_preprocess_config(args))
        deferred(engine)
        agent = BasicAgent(root=root, reader="auto")
        agent.set_independent(tinfer.make_infer_transform(args))
        system = SlamSystem(args, engine, system_id=1,
                            logger_dir=cfg["infer_tgt"])
        mapping = tmodules.MappingModule
    assert int(args.tpu.odometer_pipeline_depth) == 2
    system._platform_speed = lambda: speed
    codes = []
    process = mapping.process

    def recorded(self, new_scan, odom_edge):
        out = process(self, new_scan, odom_edge)
        codes.append(getattr(out, "name", "acpt"))
        return out

    monkeypatch.setattr(mapping, "process", recorded)
    system.MT_Init()
    for i in range(len(agent)):
        system.MT_Step(agent[i])
    system.MT_Done()
    _wait(system)
    keyframes = sorted(s.timestep for s in
                       system.posegraph_map.get_all_scans()
                       if s.type == "full")
    return codes, keyframes, system._staleness_events


def test_pipelined_keyframes_match_jax(harsh, monkeypatch):
    """Exit codes and keyframe ids equal to the JAX package's in both
    branches; every frame mapped; the fallback fires once when pinned on
    and never when pinned off; off keeps fewer keyframes than on."""
    got = {}
    for branch, speed in SPEEDS.items():
        want = run_pipelined(harsh, "jax", speed, monkeypatch)
        have = run_pipelined(harsh, "torch", speed, monkeypatch)
        assert have[0] == want[0], (branch, have[0], want[0])
        assert have[1] == want[1], (branch, have[1], want[1])
        assert have[2] == want[2] == (branch == "fallback_on"), branch
        assert len(have[0]) == N_FRAMES - 1
        got[branch] = have[1]
    assert len(got["fallback_off"]) < len(got["fallback_on"]), got
    assert np.all(np.diff(got["fallback_on"]) > 0)
