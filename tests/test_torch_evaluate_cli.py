"""The port's evaluation CLI (deeppointmap_tpu_torch/pipeline/evaluate.py,
scripts/evaluate_torch.py) against the JAX package's scripts/evaluate.py on
the same seeded KITTI-format files: the same JSON line, key for key and
value for value (both round alike), aligned and unaligned, at RPE steps 1
and 3, with files of unequal length (the common prefix), and on a path too
short for the KITTI benchmark's segments (its errors are null); the text
form and the two entry points of the port agree too."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deeppointmap_tpu_torch.data.synthetic import circle_trajectory
from deeppointmap_tpu_torch.pipeline import evaluate as tev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JEV = _load("jax_evaluate", os.path.join(REPO, "scripts/evaluate.py"))


def _write(path, poses):
    np.savetxt(path, np.stack(poses)[:, :3, :].reshape(len(poses), 12))
    return str(path)


def _pair(tmp_path, n_gt, n_pred, radius, seed):
    """A ground-truth circle of n_gt poses and a drifting, noisy estimate of
    its first n_pred poses, as KITTI files."""
    rng = np.random.default_rng(seed)
    gt = circle_trajectory(max(n_gt, n_pred), radius=radius)
    pred = []
    for i, T in enumerate(gt[:n_pred]):
        P = T.copy()
        a = 0.002 * i + rng.normal(0, 0.002)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1.0]])
        P[:3, :3] = R @ P[:3, :3]
        P[:3, 3] = R @ P[:3, 3] + rng.normal(0, 0.2, 3) + [0.01 * i, 0, 0]
        pred.append(P)
    return (_write(tmp_path / "pred.txt", pred),
            _write(tmp_path / "gt.txt", gt[:n_gt]))


CASES = {
    # name: (gt frames, pred frames, radius m, flags)
    "aligned_delta1": (120, 120, 60.0, []),
    "no_align_delta1": (120, 120, 60.0, ["--no-align"]),
    "aligned_delta3": (120, 120, 60.0, ["--delta", "3"]),
    "no_align_delta3": (120, 120, 60.0, ["--no-align", "--delta", "3"]),
    "pred_shorter": (120, 97, 60.0, []),
    "gt_shorter": (80, 120, 60.0, ["--delta", "3"]),
    # a 10 m circle: under the benchmark's 100 m segment, no KITTI error
    "too_short_for_kitti": (30, 30, 1.5, []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_json_equals_the_jax_cli(name, tmp_path, capsys):
    n_gt, n_pred, radius, flags = CASES[name]
    pred, gt = _pair(tmp_path, n_gt, n_pred, radius, seed=len(name))
    JEV.main([pred, gt, "--json", *flags])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got_ret = tev.main([pred, gt, "--json", *flags])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got_ret == want
    assert got["frames"] == min(n_gt, n_pred)
    if name == "too_short_for_kitti":
        assert got["kitti_trans_err_pct"] is None
        assert got["kitti_rot_err_deg_per_100m"] is None
    else:
        assert got["kitti_trans_err_pct"] is not None


def test_text_form_and_entry_points(tmp_path, capsys):
    """The table form equals the JAX CLI's; scripts/evaluate_torch.py and
    `python -m deeppointmap_tpu_torch.pipeline.evaluate` print the JSON
    line that main returns."""
    pred, gt = _pair(tmp_path, 60, 50, 40.0, seed=3)
    JEV.main([pred, gt, "--delta", "3"])
    want = capsys.readouterr().out
    tev.main([pred, gt, "--delta", "3"])
    assert capsys.readouterr().out == want
    ref = tev.evaluate(pred, gt, delta=3)
    for cmd in ([sys.executable, "-m", "deeppointmap_tpu_torch.pipeline."
                 "evaluate"],
                [sys.executable, os.path.join(REPO,
                                              "scripts/evaluate_torch.py")]):
        out = subprocess.run(cmd + [pred, gt, "--delta", "3", "--json"],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=120, check=True).stdout
        assert json.loads(out.strip().splitlines()[-1]) == ref
