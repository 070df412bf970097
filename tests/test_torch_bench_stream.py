"""bench_torch.py's throughput stream under configs/infer/sample.yaml with
artifacts/full_size_occ_v2, frame by frame in both packages on the CPU.

sample.yaml gates a registration at rmse 0.5 and confidence 0.6. On this
synthetic stream the trained model's registrations read rmse 2-6 at
confidence 0.7-0.9, so the rmse gate drops the frames after the first, and
the benchmark's throughput times the drop path. This test shows that the
drops are the reference's: over the first FRAMES frames both packages give
the same exit code frame by frame, each drop made by the rmse gate alone
(confidence above its gate), and the same keyframes.
"""

import os

import pytest
import torch

from deeppointmap_tpu.config import config_from_yaml as jconfig_from_yaml
from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import load_weights as jload_weights
from deeppointmap_tpu.slam import modules as jmodules
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu_torch.config import config_from_yaml
from deeppointmap_tpu_torch.data import synthetic as syn
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.pipeline.common import load_weights
from deeppointmap_tpu_torch.slam import modules as tmodules
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from test_torch_eval_gates import _run

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO,
                       "artifacts/full_size_occ_v2/weights_final.msgpack")
SAMPLE_YAML = os.path.join(REPO, "configs/infer/sample.yaml")
FRAMES = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("bench_stream")
    seq = syn.write_bins(syn.render_stream(FRAMES)[0], str(tmp / "stream"))
    args = config_from_yaml(SAMPLE_YAML, device="cpu", multi_thread=False)
    engine = InferenceEngine(args, *load_weights(args, WEIGHTS),
                             device="cpu",
                             preprocess_cfg=tinfer.device_preprocess_config(
                                 args))
    port = _run(tinfer, tmodules, args, engine, seq, str(tmp / "out_port"))
    jargs = jconfig_from_yaml(SAMPLE_YAML, multi_thread=False)
    enc, dec, ep, dp = jload_weights(jargs, WEIGHTS)
    jengine = JEngine(jargs, ep, dp, encoder=enc, decoder=dec,
                      preprocess_cfg=jinfer.device_preprocess_config(jargs))
    jax_run = _run(jinfer, jmodules, jargs, jengine, seq,
                   str(tmp / "out_jax"))
    return dict(args=args, port=port, jax=jax_run)


def test_same_exit_codes_and_keyframes(runs):
    port, jax_run = runs["port"], runs["jax"]
    assert port["codes"] == jax_run["codes"]
    assert port["keysteps"] == jax_run["keysteps"]
    assert port["timesteps"] == jax_run["timesteps"]


def test_the_rmse_gate_drops_the_stream(runs):
    """Every frame after the first is dropped in both packages, each by the
    rmse gate alone."""
    gates = runs["args"].slam_system
    for pkg in ("port", "jax"):
        assert runs[pkg]["codes"] == ["acpt"] + ["drop"] * (FRAMES - 1)
        assert len(runs[pkg]["gates"]) == FRAMES - 1
        for code, rmse, conf in runs[pkg]["gates"]:
            assert code == "drop", (pkg, runs[pkg]["gates"])
            assert rmse > gates.edge_rmse_drop, (pkg, runs[pkg]["gates"])
            assert conf > gates.edge_confidence_drop, (pkg,
                                                       runs[pkg]["gates"])
