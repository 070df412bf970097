"""The port's trajectory metrics (deeppointmap_tpu_torch/utils/evaluation.py)
against the JAX package's on seeded trajectories, at 1e-9, and the
invariances of tests/test_evaluation.py on the port's own copy."""

import numpy as np
import pytest

from deeppointmap_tpu.utils import evaluation as jev
from deeppointmap_tpu_torch.utils import evaluation as tev
from deeppointmap_tpu_torch.utils import se3 as se3m


def _traj(n=200, noise=0.0, rng=None):
    rng = rng or np.random.default_rng(0)
    out = []
    for i in range(n):
        a = i * 0.01
        R = np.array([[np.cos(a), -np.sin(a), 0],
                      [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        t = np.array([i * 1.0, np.sin(i * 0.05) * 5, 0.0])
        T = se3m.se3(R, t)
        if noise:
            T = T @ se3m.se3_exp(rng.normal(size=6) * noise)
        out.append(T)
    return np.stack(out)


def _pair(seed: int, n: int = 200):
    """A ground-truth trajectory and a noisy estimate under a rigid
    offset, both from `seed`."""
    rng = np.random.default_rng(seed)
    gt = _traj(n)
    offset = se3m.se3_exp(rng.normal(size=6) * [3, 3, 1, 0.2, 0.2, 0.5])
    pred = np.einsum("ij,njk->nik", offset, _traj(n, noise=0.01, rng=rng))
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("align", [True, False])
def test_ate_matches_jax(seed, align):
    pred, gt = _pair(seed)
    assert tev.ate_rmse(pred, gt, align) == pytest.approx(
        jev.ate_rmse(pred, gt, align), abs=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_align_se3_matches_jax(seed):
    pred, gt = _pair(seed)
    np.testing.assert_allclose(tev.align_se3(pred[:, :3, 3], gt[:, :3, 3]),
                               jev.align_se3(pred[:, :3, 3], gt[:, :3, 3]),
                               atol=1e-9)


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_matches_jax(delta):
    pred, gt = _pair(3)
    np.testing.assert_allclose(tev.rpe(pred, gt, delta),
                               jev.rpe(pred, gt, delta), atol=1e-9)


def test_kitti_errors_match_jax():
    pred, gt = _pair(4, n=400)
    got = tev.kitti_odometry_errors(pred, gt)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jev.kitti_odometry_errors(pred, gt),
                               atol=1e-9)
    # a path shorter than every standard length has no sub-sequence
    short = tev.kitti_odometry_errors(pred[:50], gt[:50])
    assert np.isnan(short).all()
    assert np.isnan(jev.kitti_odometry_errors(pred[:50], gt[:50])).all()


def test_load_kitti_matches_jax(tmp_path):
    pred, _ = _pair(5, n=20)
    path = tmp_path / "traj.txt"
    with open(path, "w") as f:
        for T in pred:
            f.write(" ".join(f"{v:.10f}" for v in T[:3, :].flatten()) + "\n")
    got = tev.load_kitti_trajectory(str(path))
    np.testing.assert_allclose(got, jev.load_kitti_trajectory(str(path)),
                               atol=1e-9)
    np.testing.assert_allclose(got, pred, atol=1e-9)


def test_ate_zero_for_identical():
    gt = _traj()
    assert tev.ate_rmse(gt, gt) < 1e-9


def test_ate_invariant_to_rigid_offset():
    gt = _traj()
    offset = se3m.se3_exp(np.array([5.0, -3.0, 1.0, 0.2, 0.1, -0.3]))
    pred = np.einsum("ij,njk->nik", offset, gt)
    assert tev.ate_rmse(pred, gt, align=True) < 1e-6
    assert tev.ate_rmse(pred, gt, align=False) > 1.0


def test_rpe_and_kitti_errors():
    gt = _traj()
    pred = _traj(noise=0.01)
    t_err, r_err = tev.rpe(pred, gt)
    assert 0 < t_err < 0.2
    assert 0 < r_err < 2.0
    terr_pct, _ = tev.kitti_odometry_errors(pred, gt)
    assert np.isfinite(terr_pct) and terr_pct < 10.0
