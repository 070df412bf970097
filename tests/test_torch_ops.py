"""The port's ops (deeppointmap_tpu_torch.ops, data.preprocess) against the
JAX package's on the CPU, on the same inputs made with numpy.

On the CPU each port op runs its kernel's plain version; the JAX package
takes its exact path (ROADMAP rule: compare against the JAX exact path).
Relative errors are max|port - jax| / max|jax| over the compared entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppointmap_tpu.data import synthetic as jsyn
from deeppointmap_tpu.data.preprocess import PreprocessConfig as JPre
from deeppointmap_tpu.data.voxel import voxel_downsample_indices as jvox
from deeppointmap_tpu.ops import infomat as jinfo
from deeppointmap_tpu.ops import kabsch as jkabsch
from deeppointmap_tpu.ops import neighbors as jnb
from deeppointmap_tpu.ops import normals as jnorm
from deeppointmap_tpu.ops import sampling as jsamp
from deeppointmap_tpu_torch.data import synthetic as tsyn
from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig as TPre
from deeppointmap_tpu_torch.data.preprocess import preprocess
from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices as tvox
from deeppointmap_tpu_torch.ops import infomat as tinfo
from deeppointmap_tpu_torch.ops import kabsch as tkabsch
from deeppointmap_tpu_torch.ops import neighbors as tnb
from deeppointmap_tpu_torch.ops import normals as tnorm
from deeppointmap_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)

TRANSFORMS = {
    "DistanceSample": {"min_dis": 1.0, "max_dis": 60.0},
    "OutlierFilter": {"nb_neighbors": 10, "std_ratio": 3.0},
    "LowPassFilter": {"normals_radius": 0.5, "normals_num": 16,
                      "filter_std": 2.0, "flux": 4, "max_remain": -1},
    "CoordinatesNormalization": {"ratio": 60.0},
}


def relerr(a, b, mask=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if mask is not None:
        a, b = a[mask], b[mask]
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def rotation_deg(A, B) -> float:
    """Angle of the rotation between A and B, from the chord
    |A - B|_F = 2 sqrt(2) sin(angle / 2), which stays accurate near 0."""
    chord = np.linalg.norm(np.asarray(A, np.float64) - np.asarray(B,
                                                                   np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, chord / (2 * np.sqrt(2))))))


def scan(seed: int, n_pad: int = 2048, max_points: int = 1900):
    """A synthetic raw-meter scan, voxel-downsampled at 0.3 m and padded
    to n_pad: (points (n_pad, 3) f32, valid (n_pad,) bool)."""
    rng = np.random.default_rng(seed)
    world = jsyn.make_world(rng, n_clusters=50, extent=30.0,
                            pts_per_cluster=300)
    pose = jsyn.circle_trajectory(24, radius=10.0)[seed % 24]
    xyz = jsyn.render_scan(world, pose, sensor_range=35.0,
                           max_points=6000, rng=rng)
    xyz = xyz[jvox(xyz, 0.3, "first")][:max_points]
    pts = np.zeros((n_pad, 3), np.float32)
    valid = np.zeros((n_pad,), bool)
    pts[:len(xyz)] = xyz
    valid[:len(xyz)] = True
    return pts, valid


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ FPS
@pytest.mark.parametrize("n,k,n_valid", [(2048, 512, 1700), (512, 128, 512),
                                         (64, 32, 20)])
def test_fps_indices_identical(n, k, n_valid):
    """Indices identical: both evaluate ((dx^2 + dy^2) + dz^2) in f32 with
    the same argmax tie rule."""
    rng = np.random.default_rng(n + k)
    xyz = rng.normal(size=(2, n, 3)).astype(np.float32)
    valid = np.zeros((2, n), bool)
    valid[0, :n_valid] = True
    valid[1] = rng.random(n) < n_valid / n
    valid[1, :3] = False                   # first valid point is not 0
    j_idx, j_sel = jsamp.batched_fps(jnp.asarray(xyz), jnp.asarray(valid), k)
    t_idx, t_sel = tsamp.batched_fps(t(xyz), t(valid), k)
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
    sel = np.asarray(j_sel)
    np.testing.assert_array_equal(t_idx.numpy()[sel], np.asarray(j_idx)[sel])


# ------------------------------------------------------------------ kNN
def _same_sets_but_ties(t_idx, t_d2, j_idx, j_d2):
    """Row sets equal, except for neighbours tied with the k-th distance
    (to the last-bit rounding by which the two distance formulas differ)."""
    for r in range(j_idx.shape[0]):
        only_t = [d for i, d in zip(t_idx[r], t_d2[r]) if i not in j_idx[r]]
        only_j = [d for i, d in zip(j_idx[r], j_d2[r]) if i not in t_idx[r]]
        kth = j_d2[r, -1]
        tol = 1e-5 * max(abs(kth), 1e-12)
        assert all(abs(d - kth) <= tol for d in only_t + only_j), r


@pytest.mark.parametrize("k", [1, 3, 17, 32])
@pytest.mark.parametrize("scale", [1.0 / 60.0, 1.0])
def test_knn_matches_jax(k, scale):
    """Index sets equal except at exact ties; dist2 relerr <= 1e-5,
    relative to the scale of the terms |c|^2 - 2 c.p + |p|^2 (the port sums
    the cross term elementwise, JAX in a HIGHEST matmul: their last bits
    differ, and the cancellation leaves that difference in the result)."""
    pts, valid = scan(1)
    pts = pts * np.float32(scale)
    rng = np.random.default_rng(k)
    centers = (pts[:700] + rng.normal(0, 0.1 * scale, (700, 3))).astype(
        np.float32)
    j_idx, j_d2 = jnb.knn(jnp.asarray(pts), jnp.asarray(centers), k,
                          jnp.asarray(valid))
    j_idx, j_d2 = np.asarray(j_idx), np.asarray(j_d2)
    t_idx, t_d2 = tnb.knn(t(pts)[None], t(centers)[None], k, t(valid)[None])
    t_idx, t_d2 = t_idx[0].numpy(), t_d2[0].numpy()
    _same_sets_but_ties(t_idx, t_d2, j_idx, j_d2)
    terms = np.max(np.sum(pts.astype(np.float64) ** 2, -1))
    err = np.max(np.abs(np.sort(t_d2, 1).astype(np.float64)
                        - np.sort(j_d2, 1)))
    assert err / terms <= 1e-5


def test_knn_fewer_valid_than_k():
    """Tail slots carry the 1e9 sentinel and in-range indices, like the
    JAX package; hybrid_query clamps them to the nearest neighbour."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    valid = np.zeros(40, bool)
    valid[[2, 5, 11, 30]] = True
    j_idx, j_d2 = jnb.knn(jnp.asarray(pts), jnp.asarray(pts), 8,
                          jnp.asarray(valid))
    t_idx, t_d2 = tnb.knn(t(pts)[None], t(pts)[None], 8, t(valid)[None])
    np.testing.assert_array_equal(t_idx[0].numpy(), np.asarray(j_idx))
    assert np.all(t_d2[0].numpy()[:, 4:] == np.float32(1e9))
    assert t_idx.min() >= 0 and t_idx.max() < 40
    j_h = jnb.hybrid_query(jnp.asarray(pts), jnp.asarray(pts), 8, 0.5,
                           jnp.asarray(valid))
    t_h = tnb.hybrid_query(t(pts)[None], t(pts)[None], 8, 0.5, t(valid)[None])
    np.testing.assert_array_equal(t_h[0].numpy(), np.asarray(j_h))


@pytest.mark.parametrize("radius", [0.05, 0.1])
def test_hybrid_query_matches_jax(radius):
    pts, valid = scan(2)
    pts = pts / np.float32(60.0)
    centers = pts[::3][:500]
    j = np.asarray(jnb.hybrid_query(jnp.asarray(pts), jnp.asarray(centers),
                                    16, radius, jnp.asarray(valid)))
    got = tnb.hybrid_query(t(pts)[None], t(centers)[None], 16, radius,
                           t(valid)[None])[0].numpy()
    # a row may differ only by an exact-tie swap: compare as sets
    assert np.mean([set(a) == set(b) for a, b in zip(got, j)]) >= 0.999


def test_knn_plain_is_exact_against_float64():
    """The plain version ranks by the f32 formula; against a float64
    brute force its neighbour sets agree on well-separated rows."""
    pts, valid = scan(4)
    pts = pts / np.float32(60.0)
    t_idx, _ = tnb.knn(t(pts)[None], t(pts[:300])[None], 8, t(valid)[None])
    p64 = pts.astype(np.float64)
    d = ((p64[:300, None] - p64[None]) ** 2).sum(-1)
    d[:, ~valid] = np.inf
    ref = np.argsort(d, axis=1, kind="stable")[:, :8]
    gap = np.sort(d, 1)[:, 8] - np.sort(d, 1)[:, 7]
    ok = gap > 1e-6
    assert ok.mean() > 0.9
    for r in np.nonzero(ok)[0]:
        assert set(t_idx[0, r].numpy()) == set(ref[r])


# ------------------------------------------------------ moments, normals
def test_filter_sweep_moments_match_jax():
    """Moments relerr <= 1e-4 (f32 sums in another order); counts exact
    (both decide membership on the same f32 distances up to last-bit
    rounding of the cross term)."""
    pts, valid = scan(5)
    j = jnorm.filter_sweep(jnp.asarray(pts), jnp.asarray(valid), 17, 0.5,
                           "exact")
    j_idx, j_d2, j_cnt, j_s, j_S6 = (np.asarray(x) for x in j)
    out = tnorm.filter_sweep(t(pts)[None], t(valid)[None], 17, 0.5)
    t_idx, t_d2, t_cnt, t_s, t_S6 = (x[0].numpy() for x in out)
    v = valid
    # membership flips only for points at the radius to within the
    # last-bit difference of the two distance formulas
    assert np.mean(t_cnt[v] == j_cnt[v]) >= 0.995
    same = t_cnt == j_cnt
    assert relerr(t_s, j_s, same & v) <= 1e-4
    assert relerr(t_S6, j_S6, same & v) <= 1e-4
    _same_sets_but_ties(t_idx[v], t_d2[v], j_idx[v], j_d2[v])


def test_normals_from_moments_match_jax():
    """The same f32 moments through both closed-form eigensolvers (the port
    in float64, JAX in float32). Both inherit the rounding of the f32
    moments, whose ~|c|^2 terms cancel at +-30 m, so against a float64
    PCA of the explicit neighbourhoods neither is exact: the port must be
    at least as close as JAX, and the two agree to |cos| >= 1 - 1e-2 on 99%
    of the neighbourhoods of three or more points. With two points the
    covariance has rank one and no defined normal: JAX returns rounding
    noise, the port +z; with one point both return +z."""
    pts, valid = scan(6)
    cnt, s, S6 = (np.asarray(x) for x in jnorm.filter_sweep(
        jnp.asarray(pts), jnp.asarray(valid), 0, 0.5, "exact"))
    j_n = np.asarray(jnorm.normals_from_moments(
        jnp.asarray(pts), jnp.asarray(cnt), jnp.asarray(s), jnp.asarray(S6)))
    t_n = tnorm.normals_from_moments(t(pts), t(cnt), t(s), t(S6)).numpy()
    well = np.nonzero(valid & (cnt >= 3))[0]
    assert len(well) > 300
    p = pts.astype(np.float64)
    ref = np.zeros((len(well), 3))
    for r, i in enumerate(well):
        q = p[valid & (np.sum((p - p[i]) ** 2, 1) <= 0.25)]
        ref[r] = np.linalg.eigh((q - q.mean(0)).T @ (q - q.mean(0)))[1][:, 0]
    cos = lambda a, b: np.abs(np.sum(a * b, -1))
    assert np.mean(cos(t_n[well], ref) >= 1 - 1e-4) >= np.mean(
        cos(j_n[well], ref) >= 1 - 1e-4)
    assert np.mean(cos(t_n[well], j_n[well]) >= 1 - 1e-2) >= 0.99
    np.testing.assert_array_equal(t_n[valid & (cnt == 1)], np.asarray(
        j_n)[valid & (cnt == 1)])
    assert np.all(t_n[valid & (cnt <= 2)] == np.float32([0, 0, 1]))


def test_smallest_eigvec_matches_jax():
    rng = np.random.default_rng(0)
    mats = []
    for _ in range(64):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        lam = np.sort(rng.uniform(0.1, 5.0, 3))[::-1]
        mats.append(q @ np.diag(lam) @ q.T)
    C = np.stack(mats).astype(np.float32)
    j = np.asarray(jnorm.smallest_eigvec_3x3(jnp.asarray(C)))
    got = tnorm.smallest_eigvec_3x3(t(C)).numpy()
    np.testing.assert_allclose(np.abs(np.sum(j * got, -1)), 1.0, atol=1e-5)


# ----------------------------------------------------------- preprocess
def _pin_two_point_normals(monkeypatch):
    """Give two-point neighbourhoods the +z normal in the JAX package, as
    the port does: their covariance has rank one, so the normal the JAX
    package returns there is rounding noise (its own jit and eager paths
    disagree on 11-13% of the survivors of these scans because of it).
    Returns the patched JAX preprocess."""
    import deeppointmap_tpu.data.preprocess as jp

    j_orig = jp.normals_from_moments

    def j_pinned(c, cnt, s, S6):
        return jnp.where((cnt <= 2)[:, None], jnp.asarray([0.0, 0.0, 1.0]),
                         j_orig(c, cnt, s, S6))

    monkeypatch.setattr(jp, "normals_from_moments", j_pinned)
    return jp.preprocess


@pytest.mark.parametrize("seed", [7, 8])
def test_preprocess_survivors_match_jax(seed, monkeypatch):
    """Survivor sets differ on <= 0.5% of the points (threshold-adjacent
    points flip with last-bit differences in the normals and the means);
    normalized coordinates are identical."""
    j_preprocess = _pin_two_point_normals(monkeypatch)
    pts, valid = scan(seed)
    j_pts, j_v = j_preprocess(jnp.asarray(pts), jnp.asarray(valid),
                              JPre.from_transforms(TRANSFORMS))
    t_pts, t_v = preprocess(t(pts)[None], t(valid)[None],
                            TPre.from_transforms(TRANSFORMS))
    j_v, t_v = np.asarray(j_v), t_v[0].numpy()
    assert 0 < j_v.sum() < valid.sum()
    assert np.sum(j_v != t_v) <= 0.005 * valid.sum()
    np.testing.assert_array_equal(t_pts[0].numpy(), np.asarray(j_pts))


def test_preprocess_config_from_transforms():
    j = JPre.from_transforms(TRANSFORMS)
    got = TPre.from_transforms(TRANSFORMS)
    for f in got._fields:
        assert getattr(got, f) == getattr(j, f), f


# --------------------------------------------------------------- Kabsch
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_kabsch_matches_jax(seed):
    """R within 0.01 deg, t within 1 mm, identical inlier masks."""
    rng = np.random.default_rng(seed)
    k = 256
    src = rng.uniform(-20, 20, (k, 3)).astype(np.float32)
    ang = rng.uniform(-0.3, 0.3)
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                   0], [0, 0, 1]])
    dst = (src @ R.T + rng.normal(0, 1, 3) + rng.normal(0, 0.05, (k, 3)))
    out = rng.random(k) < 0.2
    dst[out] += rng.normal(0, 5, (out.sum(), 3))
    dst = dst.astype(np.float32)
    w = rng.random(k).astype(np.float32)
    valid = rng.random(k) < 0.95
    jR, jt, jin, jrmse = (np.asarray(x) for x in jkabsch.weighted_kabsch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        jnp.asarray(valid)))
    tR, tt, tin, trmse = (x.numpy() for x in tkabsch.weighted_kabsch(
        t(src), t(dst), t(w), t(valid)))
    assert rotation_deg(tR, jR) <= 0.01
    assert np.linalg.norm(tt - jt) <= 1e-3
    np.testing.assert_array_equal(tin, jin)
    assert abs(float(trmse) - float(jrmse)) <= 1e-4


def test_top_k_breaks_ties_like_lax():
    x = np.array([0.5, 1.0, 0.5, 1.0, 0.25, 0.5], np.float32)
    import jax

    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = tkabsch.top_k(t(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ----------------------------------------------------- information matrix
@pytest.mark.parametrize("stride", [1, 4])
def test_information_matrix_matches_jax(stride):
    """relerr <= 1e-4: same 1-NN correspondences, G^T G summed in
    another order."""
    src, sv = scan(9)
    dst, dv = scan(10)
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                   0], [0, 0, 1]], np.float32)
    tr = np.array([0.4, -0.2, 0.05], np.float32)
    j = np.asarray(jinfo.information_matrix(
        jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst), jnp.asarray(dv),
        jnp.asarray(R), jnp.asarray(tr), stride=stride))
    got = tinfo.information_matrix(t(src), t(sv), t(dst), t(dv), t(R), t(tr),
                                   stride=stride).numpy()
    assert j[3, 3] > 10                     # many matched points
    assert relerr(got, j) <= 1e-4


# ------------------------------------------------------- host data copies
def test_voxel_and_synthetic_copies_match():
    rng_a, rng_b = np.random.default_rng(11), np.random.default_rng(11)
    wa = jsyn.make_world(rng_a, n_clusters=20, extent=20.0,
                         pts_per_cluster=100)
    wb = tsyn.make_world(rng_b, n_clusters=20, extent=20.0,
                         pts_per_cluster=100)
    np.testing.assert_array_equal(wa, wb)
    pa = jsyn.circle_trajectory(8, radius=5.0)
    pb = tsyn.circle_trajectory(8, radius=5.0)
    np.testing.assert_array_equal(np.stack(pa), np.stack(pb))
    sa = jsyn.render_scan(wa, pa[3], rng=rng_a, occlusion_bins=64)
    sb = tsyn.render_scan(wb, pb[3], rng=rng_b, occlusion_bins=64)
    np.testing.assert_array_equal(sa, sb)
    for ret in ("first", "center"):
        np.testing.assert_array_equal(tvox(sa, 0.3, ret), jvox(sa, 0.3, ret))
