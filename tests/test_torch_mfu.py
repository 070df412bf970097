"""The port's work count (deeppointmap_tpu_torch/utils/roofline.py) and its
report (scripts/mfu_profile_torch.py) on the CPU, at the SMALL and the demo
widths:

(a) the dense counts of the encoder, registration (both solves) and the
    information matrix equal what torch.utils.flop_counter.FlopCounterMode
    counts on the port's CPU forward, exactly, module by module;
(b) each per-kernel count equals a brute numpy count of valid pairs, FPS
    steps and in-radius pairs on seeded inputs with padded and invalid
    points, and its bytes equal those of the plain version's inputs and
    outputs;
(c) for the programs XLA counts whole, the port's count is within 5% below
    the JAX counterpart's cost_analysis FLOPs;
(d) XLA's FLOPs for the JAX FPS do not grow with the number of samples (a
    `while` body counts once), while the port's count grows linearly;
(e) the script runs at the demo width on the CPU with every device field
    null, and a cuda run without a card raises;
and a program's own bytes (its inputs, weights and state once, its
outputs once) are what its bound and hbm_share take.
"""

import copy
import inspect
import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deeppointmap_tpu.models.decoder import Decoder as JDecoder
from deeppointmap_tpu.ops.sampling import farthest_point_sampling
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models.decoder import Decoder, num_pairs_for
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
from deeppointmap_tpu_torch.ops import kabsch, neighbors, sampling, sweep
from deeppointmap_tpu_torch.ops.infomat import information_matrix
from deeppointmap_tpu_torch.pipeline import mfu
from deeppointmap_tpu_torch.pipeline.demo import demo_args, padded_scans
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.utils import roofline
from tests.test_torch_models import SMALL, jax_args

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo_tree() -> dict:
    """SMALL with the demo-width model's encoder and decoder trees."""
    args = demo_args("", "")
    cfg = copy.deepcopy(SMALL)
    for key in ("encoder", "decoder"):
        cfg[key] = json.loads(json.dumps(args[key]))
    cfg["tpu"]["encoder_points"] = int(args.tpu.encoder_points)
    return cfg


WIDTHS = {"small": SMALL, "demo": _demo_tree()}


def _by_module(counter: FlopCounterMode, prefix: str = "") -> dict:
    """FlopCounterMode's counts of the modules one level under `prefix`
    (class names when the call entered no parent module)."""
    out = {}
    for name, ops in counter.get_flop_counts().items():
        rest = name[len(prefix):] if name.startswith(prefix) else None
        if rest and "." not in rest:
            out[rest] = sum(ops.values())
    return out


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_encoder_dense_equals_flop_counter(width):
    """Every linear layer of the encoder, by module (point_mlp0, each
    stage, each FeaturePropagation); FPS and the plain kNN do no matrix
    product, so the counter sees the dense layers alone."""
    args = config_from_dict(WIDTHS[width])
    enc = Encoder.from_config(args).eval()
    n = int(args.tpu.encoder_points)
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(2, n, 3, generator=g) * 0.3
    valid = torch.rand(2, n, generator=g) < 0.9
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        enc(pts, valid)
    got = _by_module(counter, "Encoder.")
    want = {k: c.matmul_flops
            for k, c in roofline.encoder_dense(args.encoder, 2, n).items()}
    assert got == want
    assert counter.get_total_flops() == sum(want.values())


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("robust", [False, True], ids=["trimmed", "ransac"])
def test_registration_equals_flop_counter(width, robust):
    """Decoder.registration, M against N tokens with invalid ones: the
    projection, the attention layers, the heads by module; the pairing
    product and the solve (trimmed: 3 solves; RANSAC: 1024 hypotheses and
    3 refinements) are what is left outside the modules."""
    args = config_from_dict(WIDTHS[width])
    dec = Decoder.from_config(args).eval()
    dec.robust_register = robust
    c = int(args.decoder.in_channel)
    m, n = 256, 200
    g = torch.Generator().manual_seed(1)
    src, dst = torch.randn(m, c + 3, generator=g), torch.randn(
        n, c + 3, generator=g)
    sv, dv = torch.rand(m, generator=g) < 0.8, torch.rand(n, generator=g) < 0.8
    pairs = num_pairs_for(m, n, 0.5)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        dec.registration(src, dst, sv, dv, pairs, pairs - 7)
    got = _by_module(counter)
    want = roofline.registration_cost(args.decoder, m, n, pairs, robust)
    layers = int(args.decoder.attention_layers)
    assert got == {
        "Linear": want["projection"].matmul_flops,
        "DescriptorAttentionLayer": sum(want[f"attn{i}"].matmul_flops
                                        for i in range(layers)),
        "HeadMLP": want["similarity_head"].matmul_flops,
        "OffsetHead": want["offset_head"].matmul_flops,
        "Global": roofline.total(want).matmul_flops}
    assert counter.get_total_flops() - sum(
        v for k, v in got.items() if k != "Global") \
        == want["pairing"].matmul_flops + want["solve"].matmul_flops


@pytest.mark.parametrize("stride", [1, 4])
def test_info_matrix_equals_flop_counter(stride):
    """The moved source points and G^T G; the 1-NN is K2's."""
    g = torch.Generator().manual_seed(2)
    src, dst = torch.randn(1000, 3, generator=g), torch.randn(
        900, 3, generator=g)
    sv, dv = torch.rand(1000, generator=g) < 0.7, torch.rand(
        900, generator=g) < 0.7
    with FlopCounterMode(display=False) as counter:
        information_matrix(src, sv, dst, dv, torch.eye(3), torch.zeros(3),
                           stride=stride)
    cost = roofline.info_matrix_cost(1000, stride, int(dv.sum()))
    assert counter.get_total_flops() == cost.matmul_flops
    assert cost.total_flops == cost.matmul_flops \
        + 8 * (-(-1000 // stride)) * int(dv.sum())


def test_solver_counts_follow_the_solvers_settings():
    """The solve's count reads the solvers' own settings (ops/kabsch's
    constants, the defaults the decoder calls them with)."""
    trim = inspect.signature(kabsch.weighted_kabsch).parameters
    ransac = inspect.signature(kabsch.ransac_kabsch).parameters
    assert trim["num_iter"].default == kabsch.TRIM_SOLVES
    assert ransac["n_hyp"].default == kabsch.RANSAC_HYPOTHESES
    assert ransac["refine_taus"].default == kabsch.RANSAC_REFINE_TAUS
    d = config_from_dict(SMALL).decoder
    k = 2 * 100
    trimmed = roofline.registration_cost(d, 64, 64, 100)["solve"]
    assert trimmed == (roofline.kabsch_solve(k) + roofline.kabsch_apply(k)) \
        * kabsch.TRIM_SOLVES + roofline.kabsch_apply(k)
    robust = roofline.registration_cost(d, 64, 64, 100, robust=True)["solve"]
    hyp = kabsch.RANSAC_HYPOTHESES
    assert robust.matmul_flops == roofline.kabsch_solve(3, hyp).matmul_flops \
        + 18.0 * hyp * k + (roofline.kabsch_apply(k) + roofline.kabsch_solve(
            k)).matmul_flops * len(kabsch.RANSAC_REFINE_TAUS) \
        + roofline.kabsch_apply(k).matmul_flops


def test_encoder_bf16_moves_the_products_to_the_bf16_rate():
    """Under tpu.encoder_bf16 the encoder's products are priced at the
    bfloat16 peak, its LayerNorms (float32 statistics) at the float32 one,
    and the product count does not change."""
    e = config_from_dict(SMALL).encoder
    f32 = roofline.total(roofline.encoder_dense(e, 1, 2048))
    bf = roofline.total(roofline.encoder_dense(e, 1, 2048, roofline.BF16_ACT))
    assert bf.matmul_flops == bf.bf16_flops == f32.matmul_flops > 0
    assert bf.total_flops == f32.total_flops
    assert bf.flops == f32.flops - f32.matmul_flops
    peaks = roofline.H100_SXM
    assert bf.bound(peaks)[0] < f32.bound(peaks)[0]


# ------------------------------------------------------------------ (b)
def _clouds(seed, b=2, n=700, n_valid=(500, 37)):
    """b clouds of n points (3 m spread, some duplicated) with the given
    valid counts scattered over the slots; the rest are padding at the
    origin or invalid points among the valid ones."""
    g = np.random.default_rng(seed)
    pts = (g.normal(size=(b, n, 3)) * 3.0).astype(np.float32)
    pts[:, n // 2:n // 2 + 20] = pts[:, :20]
    valid = np.zeros((b, n), bool)
    for i, nv in enumerate(n_valid):
        valid[i, g.permutation(n - 50)[:nv]] = True
    pts[:, n - 50:] = 0.0                       # padding
    return pts, valid


def _nbytes(*tensors) -> int:
    return sum(x.nbytes for x in tensors)


def _brute_in_radius(pts, valid, centers, radius) -> int:
    """Pairs (center, valid point) with |c|^2 - 2 c.p + |p|^2 <= r^2 in
    float32, in K2's order of operations, one center at a time."""
    r2 = np.float32(radius * radius)
    sq = lambda x: (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]
    count = 0
    for b in range(pts.shape[0]):
        p = pts[b]
        for c in centers[b]:
            cross = (c[0] * p[:, 0] + c[1] * p[:, 1]) + c[2] * p[:, 2]
            d2 = sq(c) - np.float32(2.0) * cross + sq(p)
            count += int(np.sum((d2 <= r2) & valid[b]))
    return count


def test_fps_count_is_a_brute_count():
    """9 FLOPs for each valid point at each step of a numpy FPS loop, and
    the bytes of the plain version's inputs and output."""
    pts, valid = _clouds(4)
    k = 60
    brute = 0
    for b in range(pts.shape[0]):
        mind = np.where(valid[b], np.inf, -1.0)
        last = int(np.argmax(valid[b]))
        for _ in range(1, k):
            brute += int(valid[b].sum())        # one update a valid point
            d = ((pts[b] - pts[b, last]) ** 2).sum(-1)
            mind = np.where(valid[b], np.minimum(mind, d), -1.0)
            mind[last] = -1.0
            last = int(np.argmax(mind))
    cost = roofline.fps_cost(2, 700, k, int(valid.sum()))
    assert cost.flops == 9 * brute
    x, v = torch.from_numpy(pts), torch.from_numpy(valid)
    idx = sampling.farthest_point_sampling_plain(x, v, k)
    assert cost.bytes == _nbytes(x, v, idx)


@pytest.mark.parametrize("radius", [0.0, 1.2])
def test_knn_count_is_a_brute_count(radius):
    """8 FLOPs for each (center, valid point) pair, 16 more for each one
    in the radius; bytes those of knn_plain's inputs and outputs."""
    pts, valid = _clouds(5)
    g = np.random.default_rng(6)
    centers = (pts[:, :90] + g.normal(size=(2, 90, 3)) * 0.3).astype(
        np.float32)
    k = 12
    pairs = sum(int(valid[b].sum()) * 90 for b in range(2))
    cost = roofline.knn_cost(2, 700, 90, k, int(valid.sum()))
    assert cost.flops == 8 * pairs
    x, v, c = (torch.from_numpy(a) for a in (pts, valid, centers))
    out = neighbors.knn_plain(x, c, k, v, radius)
    if radius > 0:
        in_radius = neighbors.in_radius_pairs(x, v, c, radius)
        assert in_radius == _brute_in_radius(pts, valid, centers, radius)
        assert 0 < in_radius < pairs
        # cnt counts a center's in-radius points, clamped to >= 1
        assert in_radius <= int(out[2].sum())
        cost = cost + roofline.moments_cost(2, 90, in_radius)
        assert cost.flops == 8 * pairs + 16 * in_radius
    assert cost.bytes == _nbytes(x, v, c, *out)


@pytest.mark.parametrize("k", [0, 9])
def test_sweep_and_moments_count_is_a_brute_count(k):
    """K4 (k > 0) and K3 (k = 0): every point a center, 8 FLOPs a valid
    pair and 16 an in-radius one, the same moments figure as K2's; bytes
    those of the plain versions' inputs and outputs."""
    pts, valid = _clouds(7)
    radius = 1.0
    x, v = torch.from_numpy(pts), torch.from_numpy(valid)
    in_radius = neighbors.in_radius_pairs(x, v, x, radius)
    assert in_radius == _brute_in_radius(pts, valid, pts, radius)
    cost = roofline.sweep_cost(2, 700, k, int(valid.sum())) \
        + roofline.moments_cost(2, 700, in_radius)
    assert cost.flops == 8 * 700 * int(valid.sum()) + 16 * in_radius
    out = sweep.fused_sweep_plain(x, v, k, radius) if k else \
        sweep.radius_moments_plain(x, v, radius)
    assert cost.bytes == _nbytes(x, v, *out)


def test_program_counts_add_up():
    """The fused odometry step is extract + register, component by
    component; the preprocess sweep is K2 with moments at the filters'
    width; the train step counts the dense work three times and FPS /
    kNN once."""
    args = config_from_dict(SMALL)
    pre = PreprocessConfig.from_transforms(SMALL["transforms"])
    counts = roofline.ScanCounts(crop_valid=(1800,), in_radius=40000,
                                 valid=(1700,))
    ext = roofline.extract_cost(args, 2048, counts, pre)
    reg = roofline.register_cost(args, 256, 2048, 1700, 128)
    odo = roofline.odometry_cost(args, 2048, counts, 256, 128, pre)
    assert odo == {**ext, **reg}
    assert ext["preprocess_sweep"] == roofline.knn_cost(
        1, 2048, 2048, 17, 1800) + roofline.moments_cost(1, 2048, 40000)
    assert reg["info_matrix"] == roofline.info_matrix_cost(2048, 4, 1700)
    assert reg["registration"] == roofline.total(roofline.registration_cost(
        args.decoder, 256, 256, 128))
    train = roofline.train_step_cost(args, 1, 2, 2048, [1700, 1600], 1024)
    once = roofline.encoder_neighbours(args.encoder, 2048, [1700, 1600])
    for key in once:
        assert train[key] == once[key]
    assert train["encoder_dense"] == roofline.total(
        roofline.encoder_dense(args.encoder, 2, 2048)) * 3


@pytest.mark.parametrize("encoder_bf16", [False, True])
def test_tpu_bf16_moves_the_network_products_only(encoder_bf16):
    """tpu.bf16 true (the "bfloat16" policy) and false count the same
    FLOPs in every program, split differently: the network's products
    (encoder and decoder layers, attention, pairing, the loss) move to the
    bfloat16 rate, and the products over x, y, z (the solve, the
    information matrix) and the kernels stay at the float32 rate; the
    rule's linear layers read and write float32 activations, so the
    bytes do not move either (tpu.encoder_bf16's do)."""
    tree = copy.deepcopy(SMALL)
    tree["tpu"] = dict(tree["tpu"], encoder_bf16=encoder_bf16)
    args = config_from_dict(tree)
    pre = PreprocessConfig.from_transforms(SMALL["transforms"])
    counts = roofline.ScanCounts(crop_valid=(1800,), in_radius=40000,
                                 valid=(1700,))
    progs = {
        "odometry": lambda policy: roofline.odometry_cost(
            args, 2048, counts, 256, 128, pre, policy),
        "train": lambda policy: roofline.train_step_cost(
            args, 1, 2, 2048, [1700, 1600], 1024, policy)}
    for name, cost in progs.items():
        on, off = cost("bfloat16"), cost("highest")
        assert off == cost("unchanged")
        assert set(on) == set(off)
        t_on, t_off = roofline.total(on), roofline.total(off)
        assert t_on.total_flops == pytest.approx(t_off.total_flops,
                                                 rel=1e-12)
        assert t_on.matmul_flops == t_off.matmul_flops
        assert t_on.bf16_flops > t_off.bf16_flops
        assert t_on.bytes == t_off.bytes
        for key in set(on) - {"encoder_dense", "decoder_dense", "loss",
                              "registration"}:
            assert on[key] == off[key], (name, key)
    reg_on = roofline.registration_cost(args.decoder, 256, 256, 128,
                                        prec=roofline.RULE)
    reg_off = roofline.registration_cost(args.decoder, 256, 256, 128)
    assert reg_on["solve"] == reg_off["solve"]
    assert reg_on["pairing"].bf16_flops == reg_off["pairing"].matmul_flops
    # the rule's linear layer reads float32 activations rounded on the
    # fly: bytes of the float32 layer, operations at the bfloat16 rate
    rule, f32 = roofline.linear(100, 64, 32, prec=roofline.RULE), \
        roofline.linear(100, 64, 32)
    assert rule.bytes == f32.bytes and rule.bf16_flops == f32.flops
    # tpu.encoder_bf16's products are bfloat16 whatever the policy
    for policy in ("bfloat16", "highest", "unchanged"):
        assert roofline.product_precision(policy, True) == roofline.BF16_ACT
    with pytest.raises(ValueError):
        roofline.extract_cost(args, 2048, counts, pre, "medium")
    with pytest.raises(ValueError):
        roofline.linear(100, 64, 32, prec="medium")


# ------------------------------------------------------------------ (c)
def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"])


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_decoder_programs_match_xla(width):
    """Registration (M 256 against N 128 tokens), a program XLA counts
    whole: no Pallas call, and the one `while`, the trimmed Kabsch loop (a
    few thousand FLOPs a solve over 2 x num_pairs points), is counted once
    by XLA and three times here.
    Tolerance: the port's count lies within 5% below XLA's, because XLA
    also counts the elementwise work the port's leaves out (bias adds,
    ReLU, residual and positional adds, masks, the sine embedding, the
    normalisations): each is O(rows x C) against the products'
    O(rows x C^2), under 5% at these widths (64 to 256 channels)."""
    cfg = WIDTHS[width]
    _, dec, _, dec_p = init_params(jax_args(cfg), seed=0)
    args = config_from_dict(cfg)
    c = int(args.decoder.in_channel)
    g = np.random.default_rng(8)
    m, n = 256, 128
    src = g.normal(size=(m, c + 3)).astype(np.float32)
    dst = g.normal(size=(n, c + 3)).astype(np.float32)
    sv, dv = np.ones(m, bool), np.ones(n, bool)
    pairs = num_pairs_for(m, n, 0.5)
    xla = _xla_flops(lambda s, d, a, b: dec.apply(
        dec_p, s, d, a, b, pairs, pairs, method=JDecoder.registration),
        src, dst, sv, dv)
    mine = roofline.total(roofline.registration_cost(
        args.decoder, m, n, pairs)).total_flops
    assert 0.95 * xla <= mine <= xla, (mine, xla)


# ------------------------------------------------------------------ (d)
def test_xla_counts_the_fps_loop_once():
    """The JAX package's XLA FPS (ops/sampling.py, a fori_loop): its FLOPs
    grow by at most a few a sample (the k-long index vectors), not by a
    step's 9 a point, while the port's count is 9 x valid x (k - 1)."""
    g = np.random.default_rng(9)
    n = 512
    x = g.normal(size=(n, 3)).astype(np.float32)
    v = np.ones(n, bool)
    xla = {k: _xla_flops(lambda a, b, k=k: farthest_point_sampling(a, b, k),
                         x, v) for k in (8, 64, 256)}
    port = {k: roofline.fps_cost(1, n, k, n).flops for k in xla}
    assert xla[256] - xla[8] <= 4 * (256 - 8)
    assert port[256] / port[8] == 255 / 7
    assert port[64] - port[8] == 9 * n * 56
    assert xla[256] < port[256] / 50


# ------------------------------------------------------------------ (e)
def test_script_on_the_cpu_at_the_demo_width(tmp_path):
    """Counts printed and written, every device field null, exit 0."""
    out = tmp_path / "mfu.json"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "mfu_profile_torch.py"),
         "--device", "cpu", "--trials", "1", "--model", "demo",
         "--json_out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    report = json.loads(out.read_text())
    assert report["device"] is None and report["peaks"] is None
    names = [row["program"] for row in report["rows"]]
    assert names == ["extract (preprocess+encoder)",
                     "fused odometry (extract+reg+info)",
                     "register 128v128 (+info)"]
    for row in report["rows"]:
        assert row["gflops"] > 0 and 0 < row["gbytes"]
        assert row["unfused_gbytes"] > 0
        for key in ("ms", "achieved_tflops", "mfu", "hbm_share",
                    "roofline_share", "bound_ms", "bound_by", "device"):
            assert row[key] is None, key
    extract, odometry, register = report["rows"]
    assert set(extract["components"]) == {"preprocess_sweep", "fps",
                                          "sa_level_knn", "fp_3nn",
                                          "encoder_dense"}
    assert set(odometry["components"]) == set(extract["components"]) | set(
        register["components"]) == set(extract["components"]) | {
            "registration", "info_matrix"}
    assert odometry["gflops"] == pytest.approx(extract["gflops"]
                                               + register["gflops"], rel=0.01)
    assert "extract (preprocess+encoder)" in r.stdout


def test_cuda_without_a_card_raises(monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "mfu_profile_torch", os.path.join(ROOT, "scripts",
                                          "mfu_profile_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["--device", "cuda", "--model", "demo"])
    assert roofline.device_peaks("cpu") == (None, None)


def test_train_step_takes_the_full_model_only():
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "mfu_profile_torch.py"),
         "--device", "cpu", "--model", "demo", "--train_step"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 2 and "full-width model only" in r.stderr


class _Props(NamedTuple):
    uuid: str


@pytest.mark.parametrize("index,power", [(0, "700.00 W"), (1, "350.00 W")])
def test_device_peaks_names_the_card_or_raises(monkeypatch, index, power):
    """A known card gets the data sheet's peaks and the power limit of the
    same card, found in nvidia-smi's list by UUID (its order need not be
    torch's); an unknown card raises instead of taking another's peaks, as
    does a UUID nvidia-smi does not list."""
    uuids = ["a1b2c3d4-0000-1111-2222-333344445555",
             "0f0e0d0c-9999-8888-7777-666655554444"]
    smi = ("GPU-0f0e0d0c-9999-8888-7777-666655554444, 350.00 W\n"
           "GPU-a1b2c3d4-0000-1111-2222-333344445555, 700.00 W\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: index)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props(uuids[i]))
    monkeypatch.setattr(
        roofline.subprocess, "run", lambda *a, **k: subprocess.
        CompletedProcess(a, 0, stdout=smi, stderr=""))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    peaks, card = roofline.device_peaks("cuda")
    assert peaks == roofline.H100_SXM == (67e12, 989e12, 3.35e12)
    assert card == dict(name="NVIDIA H100 80GB HBM3", count=2,
                        power_limit=power)
    assert roofline.device_peaks(f"cuda:{1 - index}")[1]["power_limit"] \
        != power
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props("ffffffff-0000-0000-0000-000000000000"))
    with pytest.raises(RuntimeError, match="no card with UUID"):
        roofline.device_peaks("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 PCIe")
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.device_peaks("cuda")


def test_report_row_shares():
    """mfu, hbm_share and roofline_share from a time, the program's own
    bytes and the peaks; the components' traffic is reported apart and
    bounds nothing; a count the card could not have done in the time reads
    above 1."""
    parts = {"a": roofline.Cost(flops=67e9, bytes=50e9),
             "b": roofline.Cost(bf16_flops=989e9)}
    row = roofline.report_row("p", parts, 1.675e9, 4.0, roofline.H100_SXM,
                              dict(name="x"))
    assert row["gbytes"] == pytest.approx(1.675)
    assert row["unfused_gbytes"] == pytest.approx(50.0)
    assert row["mfu"] == pytest.approx(0.5)
    assert row["hbm_share"] == pytest.approx(0.125)
    assert row["roofline_share"] == pytest.approx(0.5)
    assert row["bound_ms"] == pytest.approx(2.0)
    assert row["bound_by"] == "operations" and roofline.shares_ok(row)
    assert row["components"]["a"]["bound_by"] == "bytes"
    assert not roofline.shares_ok(roofline.report_row(
        "p", parts, 1.675e9, 1.0, roofline.H100_SXM, None))
    assert not roofline.shares_ok(roofline.report_row(
        "p", parts, 1.675e9, None, None, None))


class _Batch(NamedTuple):
    points: np.ndarray
    valid: np.ndarray


def test_io_bytes_counts_each_object_once():
    lin = torch.nn.Linear(5, 3)
    ln = torch.nn.LayerNorm(4)
    ln.register_buffer("seen", torch.zeros(7, dtype=torch.int64))
    batch = _Batch(np.zeros((2, 3, 3), np.float32), np.zeros((2, 3), bool))
    assert roofline.io_bytes(lin) == 4 * (15 + 3)
    assert roofline.io_bytes(ln) == 4 * 8 + 8 * 7
    assert roofline.io_bytes(batch) == 72 + 6
    assert roofline.io_bytes(
        {"w": torch.zeros(10, dtype=torch.float16), "n": 3},
        [lin, (batch, 1.5)], None) == 20 + 72 + 72 + 6


def _small_engine():
    args = config_from_dict(SMALL)
    torch.manual_seed(0)
    enc, dec = Encoder.from_config(args), Decoder.from_config(args)
    return InferenceEngine(
        args, enc.state_dict(), dec.state_dict(), device="cpu",
        preprocess_cfg=PreprocessConfig.from_transforms(SMALL["transforms"]))


def test_engine_programs_bytes_are_their_inputs_weights_and_outputs():
    """Each engine program's bytes: the scans it reads, the weights of the
    modules it runs and its outputs, once each; its count is the one
    roofline gives for this run's scans."""
    engine = _small_engine()
    n = 2048
    pts, valid = padded_scans(60, 2, n)
    extract, odometry, register = mfu.engine_programs(engine, pts, valid)
    enc = roofline.io_bytes(engine.encoder)
    dec = roofline.io_bytes(engine.decoder)
    assert enc == 4 * sum(p.numel() for p in engine.encoder.parameters())
    scan = n * 3 * 4 + n
    with torch.inference_mode():
        desc, dvalid, pv = extract.call()
        odo = odometry.call()
        reg = register.call()
    tokens, c = desc.shape[1], desc.shape[2]
    assert tokens == engine.n_tokens
    out_extract = tokens * c * 4 + tokens + n
    assert extract.nbytes == scan + enc + out_extract
    cand = tokens * c * 4 + tokens + n * 3 * 4 + n
    assert odometry.nbytes == scan + cand + enc + dec + roofline.io_bytes(odo)
    assert register.nbytes == 2 * cand + dec + roofline.io_bytes(reg)
    counts = mfu.scan_counts(engine.preprocess_cfg,
                             torch.from_numpy(pts[1:2]),
                             torch.from_numpy(valid[1:2]), pv)
    assert counts.valid == (int(pv.sum()),) and 0 < counts.valid[0] < 2000
    assert counts.in_radius > 0
    assert extract.parts == roofline.extract_cost(
        engine.args, n, counts, engine.preprocess_cfg)
    for p in (extract, odometry, register):
        assert p.nbytes < roofline.total(p.parts).bytes


def test_train_program_bytes_are_batch_weights_and_optimizer_state():
    """A step reads the batch, every weight and the optimizer's state and
    writes the trained weights and the state: the frozen decoder is read
    only, AdamW's two moments a trained weight are read and written."""
    args = config_from_dict({**SMALL, "train": {
        "registration": {"max_pairs": 64}}})

    class Trainer:
        def __init__(self):
            torch.manual_seed(0)
            self.encoder = Encoder.from_config(args)
            self.decoder = Decoder.from_config(args).requires_grad_(False)
            self.optimizer = torch.optim.AdamW(self.encoder.parameters())
            self.steps = 0

        def train_step(self, batch):
            self.optimizer.zero_grad()
            loss = sum((p * p).sum() for p in self.encoder.parameters())
            loss.backward()
            self.optimizer.step()
            self.steps += 1
            return {"loss": float(loss.detach())}

    trainer = Trainer()
    valid = np.zeros((1, 2, 2048), bool)
    valid[0, 0, :1900], valid[0, 1, :1800] = True, True
    batch = _Batch(np.zeros((1, 2, 2048, 3), np.float32), valid)
    prog = mfu.train_program(trainer, args, batch)
    assert trainer.steps == 1
    enc = sum(p.numel() for p in trainer.encoder.parameters())
    dec = sum(p.numel() for p in trainer.decoder.parameters())
    step = sum(roofline.io_bytes(st["step"])
               for st in trainer.optimizer.state.values())
    assert prog.nbytes == batch.points.nbytes + batch.valid.nbytes \
        + 4 * (enc + dec) + 4 * enc + 2 * (2 * 4 * enc + step)
    assert prog.parts == roofline.train_step_cost(args, 1, 2, 2048,
                                                  [1900, 1800], 64)
    assert prog.name == "stage-1 train step (S=2, b=1)"
    prog.call()
    assert trainer.steps == 2
