"""Data parallelism in the port (parallel/ddp.py): two gloo processes on
the CPU (tests/test_torch_ddp_worker.py), each stepping on its half of the
global batch, against one process stepping on the whole batch, for one SGD
step of each stage. The transforms drop a random share of each frame's
points, so the ranks hold different numbers of valid points and pairs:
without the counts summed over the ranks the two runs would differ.

Tolerances (the JAX package's own data-parallel ones,
tests/test_trainer_dp.py): the loss rtol 1e-5, the parameters rtol 2e-4,
atol 1e-6; both ranks hold the same parameters bit for bit. Divergent
seeds make the determinism probe refuse to start on both ranks.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from tests import test_torch_ddp_worker as worker
from tests.test_trainer import make_synthetic_dataset, train_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_ddp_worker.py")
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The config (two items a global step in both stages, SGD, random
    point drop) and the parameters, written for the workers."""
    root = str(tmp_path_factory.mktemp("ddp_ds"))
    make_synthetic_dataset(root, n_frames=16)
    work = tmp_path_factory.mktemp("ddp_work")
    cfg = json.loads(json.dumps(train_args(root)))
    cfg["transforms"] = {"RandomDrop": {"max_ratio": 0.5, "p": 1.0},
                         "CoordinatesNormalization": {"ratio": 60.0},
                         "ToTensor": {"padding_to": -1}}
    for tree in ("registration", "loop_detection"):
        cfg["train"][tree].update(batch_size=2, optimizer=dict(
            type="sgd", kwargs=dict(lr=1e-3)))
    cfg["infer_tgt"] = str(work / "log")
    (work / "cfg.json").write_text(json.dumps(cfg))
    _, _, ep, dp = init_params(JConfig(copy.deepcopy(cfg)), seed=7)
    torch.save(state_dicts_from_jax(ep, dp), str(work / "params.pt"))
    return str(work)


def run_ranks(work: str, seeds) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--rank", str(r), "--world", "2",
         "--port", str(port), "--work", work, "--seed", str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r, seed in enumerate(seeds)]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=TIMEOUT_S)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_two_ranks_match_one_process(work):
    results = run_ranks(work, (0, 0))
    for code, text in results:
        assert code == 0, text[-3000:]
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
             for r in range(2)]
    single = worker.step_stages(worker.build(work, 0))
    for stage in (1, 2):
        want_m, want_valid, want_p = single[stage]
        (m0, v0, p0), (m1, v1, p1) = ranks[0][stage], ranks[1][stage]
        assert m0 == m1
        np.testing.assert_allclose(m0["loss"], want_m["loss"], rtol=1e-5)
        for k in want_m:
            np.testing.assert_allclose(m0[k], want_m[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        # the halves hold different counts, and make up the whole batch
        assert v0 != v1 and np.add(v0, v1).tolist() == want_valid
        for k, want in want_p.items():
            assert torch.equal(p0[k], p1[k]), k
            torch.testing.assert_close(p0[k], want, rtol=2e-4, atol=1e-6,
                                       msg=k)


def test_divergent_seeds_are_refused(work):
    for code, text in run_ranks(work, (0, 1)):
        assert code == 3, text[-3000:]
        assert "batch divergence" in text
