"""The engine's device programs on the card: K5 (csrc/kabsch.cu, the
batched weighted Kabsch solve) against the plain solve, and extraction and
registration replayed from CUDA graphs (utils/graphs.py) against their
eager runs. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them: `python -m pytest --noconftest
tests/test_torch_engine_graphs.py`.
"""

import os
import threading

import numpy as np
import pytest
import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.data import synthetic as syn
from deeppointmap_tpu_torch.models.decoder import num_pairs_for
from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
from deeppointmap_tpu_torch.ops import kabsch
from deeppointmap_tpu_torch.pipeline import infer
from deeppointmap_tpu_torch.pipeline.demo import demo_args
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.utils import graphs, timer

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "artifacts", "synthetic_demo",
                       "weights_final.msgpack")

#: K5 against the plain solve taken in float64 on the same float32 inputs:
#: K5 sums and decomposes in float64 and rounds R and t to float32 once,
#: so both agree to a few float32 ulps of R's entries (<= 1) and of t
#: (the clouds here lie within ~60 m: an ulp is 4e-6 m)
R_TOL = 2e-6
T_TOL = 2e-5


@pytest.fixture
def dev():
    """The card, or a skip: CUDA kernels and graphs have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ------------------------------------------------------------------ K5
def _rotations(g, b):
    q = g.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _problems(b, k, seed, scale=20.0, noise=0.05):
    """b sets of k pairs: dst = R src + t + noise, weights in (0, 1]."""
    g = np.random.default_rng(seed)
    src = g.normal(size=(b, k, 3)) * scale
    R = _rotations(g, b)
    t = g.normal(size=(b, 1, 3)) * 5.0
    dst = np.einsum("bij,bkj->bki", R, src) + t \
        + g.normal(size=(b, k, 3)) * noise
    w = g.uniform(0.05, 1.0, size=(b, k))
    return [torch.from_numpy(x.astype(np.float32)) for x in (src, dst, w)]


def _plain64(src, dst, w):
    R, t = kabsch._solve_rt_plain(src.double(), dst.double(), w.double())
    return R.float(), t.float()


def _cost(R, t, src, dst, w):
    """The weighted squared residual that a Kabsch solve minimises."""
    src, dst, w, R, t = (x.double() for x in (src, dst, w, R, t))
    res = torch.einsum("...ij,...kj->...ki", R, src) + t[..., None, :] - dst
    return ((res ** 2).sum(-1) * w).sum(-1)


def _proper(R):
    eye = torch.eye(3, dtype=torch.float64, device=R.device)
    R = R.double()
    assert float((R @ R.transpose(-1, -2) - eye).abs().max()) < 1e-6
    assert float((torch.linalg.det(R) - 1).abs().max()) < 1e-6


@pytest.mark.parametrize("b,k", [(1024, 3), (1, 2176), (1, 512),
                                 (4, 4096), (300, 200), (5, 1)])
def test_kabsch_matches_plain(dev, b, k):
    """The RANSAC hypotheses (1024 x 3), the refine and trimmed solves of
    one set (up to 2 x 1088 pairs in the 4096-token bucket, 4096 from map
    to map) and both layouts' edges: R and t within R_TOL / T_TOL of the
    plain solve in float64, and within float32's own error of the plain
    solve in float32 (its median)."""
    src, dst, w = (x.to(dev) for x in _problems(b, k, b * 7919 + k))
    before = kernels.KABSCH.launches
    R, t = kabsch._solve_rt(src, dst, w)
    assert kernels.KABSCH.launches == before + 1
    assert kernels.KABSCH.shapes[kabsch.solve_shape(b, k)] >= 1
    R64, t64 = _plain64(src, dst, w)
    torch.cuda.synchronize()
    if k >= 3:
        torch.testing.assert_close(R, R64, rtol=0, atol=R_TOL)
        torch.testing.assert_close(t, t64, rtol=0, atol=T_TOL)
        R32, t32 = kabsch._solve_rt_plain(src, dst, w)
        assert float((R - R32).abs().flatten(1).max(1).values.median()) \
            < 1e-4
    else:   # a pair: any rotation about the pair's line is a minimiser
        assert torch.allclose(_cost(R, t, src, dst, w),
                              _cost(R64, t64, src, dst, w), atol=1e-6)
    _proper(R)


def test_kabsch_reflection(dev):
    """A mirrored cloud: the best orthogonal map is a reflection, and both
    solves take the best proper rotation (the third axis flipped)."""
    src, dst, w = (x.to(dev) for x in _problems(64, 50, 3, noise=0.01))
    dst = dst * torch.tensor([1.0, 1.0, -1.0], device=dev)
    R, t = kabsch._solve_rt(src, dst, w)
    R64, t64 = _plain64(src, dst, w)
    _proper(R)
    torch.testing.assert_close(R, R64, rtol=0, atol=R_TOL)
    torch.testing.assert_close(t, t64, rtol=0, atol=T_TOL)


def test_kabsch_zero_and_partial_weights(dev):
    """No weight: R = I, t = 0, finite. Half the pairs at weight 0 (the
    masked pairs of a solve): the same answer as the solve over the
    weighted half alone, and as the plain solve."""
    src, dst, w = (x.to(dev) for x in _problems(8, 400, 11))
    R0, t0 = kabsch._solve_rt(src, dst, torch.zeros_like(w))
    torch.testing.assert_close(
        R0, torch.eye(3, device=dev).expand(8, 3, 3), rtol=0, atol=0)
    torch.testing.assert_close(t0, torch.zeros(8, 3, device=dev), rtol=0,
                               atol=0)
    keep = torch.arange(400, device=dev) % 2 == 0
    wp = w * keep
    R, t = kabsch._solve_rt(src, dst, wp)
    Rh, th = kabsch._solve_rt(src[:, keep].contiguous(),
                              dst[:, keep].contiguous(),
                              w[:, keep].contiguous())
    R64, t64 = _plain64(src, dst, wp)
    for a, b_ in ((R, Rh), (R, R64)):
        torch.testing.assert_close(a, b_, rtol=0, atol=R_TOL)
    for a, b_ in ((t, th), (t, t64)):
        torch.testing.assert_close(a, b_, rtol=0, atol=T_TOL)


def test_kabsch_near_collinear(dev):
    """Points within a millimetre of one line: only that millimetre fixes
    the rotation about the line (S's two small singular values are ~1e-9
    of the large one, below float64's resolution of S^T S). K5 works on S
    itself, so its answer is a proper rotation whose weighted residual is
    the plain float64 solve's, to 1e-6 m^2 (a turn about the line off by
    0.07 rad would add that much)."""
    g = np.random.default_rng(5)
    b, k = 32, 300
    s = g.normal(size=(b, k, 1)) * 20.0
    axis = g.normal(size=(b, 1, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    src = s * axis + g.normal(size=(b, k, 3)) * 1e-3
    R_true = _rotations(g, b)
    dst = np.einsum("bij,bkj->bki", R_true, src) + 2.0
    src, dst = (torch.from_numpy(x.astype(np.float32)).to(dev)
                for x in (src, dst))
    w = torch.ones(b, k, device=dev)
    R, t = kabsch._solve_rt(src, dst, w)
    R64, t64 = _plain64(src, dst, w)
    _proper(R)
    c, c64 = _cost(R, t, src, dst, w), _cost(R64, t64, src, dst, w)
    assert bool((c <= c64 * 1.01 + 1e-6).all()), (c - c64).abs().max()


def test_kabsch_no_sync(dev):
    """K5 launches on the current stream and never syncs."""
    src, dst, w = (x.to(dev) for x in _problems(1024, 3, 1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kabsch._solve_rt(src, dst, w)
        kabsch._solve_rt(src[:1].reshape(1, -1, 3).contiguous(),
                         dst[:1].reshape(1, -1, 3).contiguous(),
                         w[:1].reshape(1, -1).contiguous())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_kabsch_rejects(dev):
    src, dst, w = (x.to(dev) for x in _problems(2, 10, 0))
    with pytest.raises(ValueError):
        kabsch.solve_rt_cuda(src.double(), dst, w)
    with pytest.raises(ValueError):
        kabsch.solve_rt_cuda(src, dst[:, :5], w)
    with pytest.raises(ValueError):
        kabsch.solve_rt_cuda(src[:, :0], dst[:, :0], w[:, :0])


# --------------------------------------------------------------- graphs
@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs run only on the card)")
    args = demo_args("", "")
    return InferenceEngine(args, *load_msgpack_weights(WEIGHTS),
                           preprocess_cfg=infer.device_preprocess_config(
                               args), device="cuda")


def _scans(engine, n):
    """n synthetic scans of the demo world, padded, on the card as
    `_extract_impl` takes them."""
    rng = np.random.default_rng(0)
    world = syn.make_world(rng)
    pad = int(engine.args.tpu.encoder_points)
    out = []
    for pose in syn.circle_trajectory(n, radius=25.0):
        xyz = syn.render_scan(world, pose, rng=rng, max_points=pad)
        pts = np.zeros((1, pad, 3), np.float32)
        valid = np.zeros((1, pad), bool)
        pts[0, :len(xyz)], valid[0, :len(xyz)] = xyz, True
        if engine.preprocess_cfg is None:
            pts /= engine.coor_scale
        out.append(engine._dequant_input(*engine.upload_scan(pts, valid)))
    return out


def _counted(fn, *a):
    """fn(*a) and the graph counts it made (its spans left out)."""
    with timer.scope("test", 0) as tally:
        out = fn(*a)
    return out, {k: v for k, v in tally.items()
                 if k in (graphs.EAGER, graphs.REPLAY)}


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (x - y).abs().max()


@torch.inference_mode()
def test_extraction_replays_bit_equal(engine):
    """First call eager, second captured and replayed, third replayed:
    each replay equals the eager program bit for bit on its own input, and
    what the second call returned is untouched by the third."""
    s = _scans(engine, 3)
    engine._graphs = graphs.Graphs()
    _, t0 = _counted(engine._extract_impl, *s[0])
    out1, t1 = _counted(engine._extract_impl, *s[1])
    kept = tuple(x.clone() for x in out1)
    out2, t2 = _counted(engine._extract_impl, *s[2])
    assert (t0, t1, t2) == ({graphs.EAGER: 1}, {graphs.EAGER: 1},
                            {graphs.REPLAY: 1})
    assert len(engine._graphs) == 1
    _same(out1, engine._extract_eager(*s[1]))
    _same(out2, engine._extract_eager(*s[2]))
    _same(out1, kept)


def _reg_inputs(engine, n):
    """n (src, dst, src valid, dst valid, num_pairs_actual) of the demo
    model's descriptors, one token bucket, pair counts that differ."""
    s = _scans(engine, n + 1)
    descs = [engine._extract_eager(*x)[:2] for x in s]
    m = descs[0][0].shape[1]
    out = []
    for i in range(n):
        (a, av), (b, bv) = descs[i], descs[i + 1]
        av = av[0].clone()
        av[m - 7 * (i + 1):] = False        # fewer real tokens each time
        out.append((a[0], b[0], av, bv[0],
                    num_pairs_for(int(av.sum()), int(bv[0].sum()))))
    return out, num_pairs_for(m, m)


@pytest.mark.parametrize("robust", [True, False])
@torch.inference_mode()
def test_registration_replays_bit_equal(engine, robust):
    """Registration (RANSAC or the trimmed solve, K5 inside) replayed with
    `num_pairs_actual` a device scalar equals the eager program with the
    host int, bit for bit; the second call's results survive the third."""
    dec = engine.decoder
    dec.robust_register = robust
    dec._graphs = graphs.Graphs()
    regs, k = _reg_inputs(engine, 3)
    outs = [_counted(dec.registration, *r[:4], k, r[4]) for r in regs]
    assert [t for _, t in outs] == [{graphs.EAGER: 1}, {graphs.EAGER: 1},
                                    {graphs.REPLAY: 1}]
    kept = tuple(x.clone() for x in outs[1][0])
    outs = [o for o, _ in outs]
    outs.append(dec.registration(*regs[1][:4], k, regs[1][4]))
    assert len(dec._graphs) == 1
    for o, r in zip(outs[1:], regs[1:] + regs[1:2]):
        _same(o, dec._registration_eager(*r[:4], k, r[4]))
    _same(outs[1], kept)
    dec.robust_register = bool(engine.args.tpu.get("robust_register",
                                                   False))


@torch.inference_mode()
def test_two_threads_two_streams(engine):
    """Two threads, each on a stream of its own, register at once: each
    stream gets its own graph, and every result equals the eager run."""
    dec = engine.decoder
    dec._graphs = graphs.Graphs()
    regs, k = _reg_inputs(engine, 4)
    want = [dec._registration_eager(*r[:4], k, r[4]) for r in regs]
    torch.cuda.synchronize()
    got, errors = {}, []

    def work(i):
        try:
            stream = torch.cuda.Stream()
            with torch.inference_mode(), torch.cuda.stream(stream):
                for rep in range(3):
                    for j in range(len(regs)):
                        r = regs[(j + i) % len(regs)]
                        got[(i, rep, j)] = (
                            (j + i) % len(regs),
                            dec.registration(*r[:4], k, r[4]))
                stream.synchronize()
        except Exception as e:      # noqa: BLE001 - handed to the test
            errors.append(e)
    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(dec._graphs) == 2
    for idx, out in got.values():
        _same(out, want[idx])


@torch.inference_mode()
def test_two_threads_default_stream_two_keys(engine):
    """Two threads on the default stream (as the pipelined mode's stages
    and the agents of one process run) replay two registration keys that
    share the decoder's memory pool, interleaved: every result equals the
    eager run bit for bit, so neither replay writes over the other's
    outputs before they are copied out."""
    dec = engine.decoder
    dec._graphs = graphs.Graphs()
    regs, k = _reg_inputs(engine, 4)
    m = regs[0][0].shape[0]
    half = m // 2
    keys = [(r[:4], k, r[4]) for r in regs[:2]] + [
        ((r[0], r[1][:half].contiguous(), r[2], r[3][:half].contiguous()),
         num_pairs_for(m, half),
         num_pairs_for(int(r[2].sum()), int(r[3][:half].sum())))
        for r in regs[2:]]
    jobs = [keys[:2], keys[2:]]     # thread i: key i, two inputs
    want = [[dec._registration_eager(*a, n, act) for a, n, act in job]
            for job in jobs]
    for job in jobs:                # captured before the threads start
        for a, n, act in job:
            dec.registration(*a, n, act)
    assert len(dec._graphs) == 2
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def work(i):
        try:
            with torch.inference_mode():
                for rep in range(40):
                    j = rep % 2
                    a, n, act = jobs[i][j]
                    got[i].append((j, dec.registration(*a, n, act)))
        except Exception as e:      # noqa: BLE001 - handed to the test
            errors.append(e)
    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(dec._graphs) == 2
    torch.cuda.synchronize()
    for i in range(2):
        assert len(got[i]) == 40
        for j, out in got[i]:
            _same(out, want[i][j])


@torch.inference_mode()
def test_launch_counts_after_replays(engine):
    """A replayed program counts its hand-written kernels' launches as an
    eager call does: per call and per shape."""
    s = _scans(engine, 4)
    engine._graphs = graphs.Graphs()
    kernels.reset_launches()
    engine._extract_eager(*s[0])
    once = {(k.name, sh): c for k in kernels.ALL for sh, c in k.shapes.items()}
    assert once
    kernels.reset_launches()
    for x in s:
        engine._extract_impl(*x)
    torch.cuda.synchronize()
    got = {(k.name, sh): c for k in kernels.ALL for sh, c in k.shapes.items()}
    assert got == {key: 4 * c for key, c in once.items()}
    dec = engine.decoder
    dec._graphs = graphs.Graphs()
    regs, k = _reg_inputs(engine, 3)
    kernels.reset_launches()
    dec._registration_eager(*regs[0][:4], k, regs[0][4])
    per = kernels.KABSCH.launches
    assert per >= 2
    kernels.reset_launches()
    for r in regs + regs:
        dec.registration(*r[:4], k, r[4])
    assert kernels.KABSCH.launches == 6 * per


@torch.inference_mode()
def test_replays_make_no_sync(engine):
    """Once captured, neither program syncs with the host: not in the
    copies in, the replay or the copies out."""
    s = _scans(engine, 3)
    engine._graphs = graphs.Graphs()
    dec = engine.decoder
    dec._graphs = graphs.Graphs()
    regs, k = _reg_inputs(engine, 3)
    for x in s[:2]:
        engine._extract_impl(*x)
    for r in regs[:2]:
        dec.registration(*r[:4], k, r[4])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._extract_impl(*s[2])
        dec.registration(*regs[2][:4], k, regs[2][4])
        dec._registration_eager(*regs[2][:4], k, regs[2][4])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
