"""The port's `tpu.bf16` rule (deeppointmap_tpu_torch/utils/precision.py)
against the JAX package run under the TPU's rule, on the CPU.

The JAX package on the CPU ignores `jax_default_matmul_precision =
"bfloat16"`, so the TPU is emulated here without touching the package:
`emulate` traces a JAX function to a jaxpr and evaluates it with every
float32 `dot_general` at default precision whose innermost line in the
package is one of precision.GOVERNED given operands rounded to bfloat16
(`lax.reduce_precision`, a rounding that XLA keeps under jit) and a
float32 result; every other equation binds unchanged. The interpreter
walks `jit`, `custom_jvp_call`, `custom_vjp_call`, `closed_call` and
`remat2`, and fails on an unpinned float32 dot inside any other sub-jaxpr
(`while`, `scan`, `cond`, ...), which it cannot reach.

Cases: (a) the product against JAX's `preferred_element_type` dot; (b)
the MLP, attention, the decoder heads, registration and loop detection at
small width with perturbed parameters; (d) the traced JAX serving and
training programs' unpinned float32 products, by line, are GOVERNED and
FLOAT32 exactly; (e) the float32 policies run the float32 code bit for
bit, and the coordinate products do not move with the rule; (f) the
product's gradient. The slice (c) and one training step (f) are in
test_torch_precision_slice.py, the cuBLAS route on the card (g) in
test_torch_precision_cuda.py (no JAX: it runs on the card).

Tolerances: the port and the emulation round the same operands to
bfloat16 and sum exact products in float32 in another order, so an
operand at a rounding boundary may round the other way in a later layer:
stated per case below, each a few times the largest difference seen over
the seeds, and each far below what the rule itself moves (checked
beside it).
"""

import functools
import os

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from jax import lax
from jax.extend import core as jcore

import deeppointmap_tpu
from deeppointmap_tpu.models import common as jcommon
from deeppointmap_tpu.models.decoder import Decoder as JDecoder
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.models import common as tcommon
from deeppointmap_tpu_torch.models.decoder import Decoder, num_pairs_for
from deeppointmap_tpu_torch.models.weights import (state_dict_from_flax,
                                                   state_dicts_from_jax)
from deeppointmap_tpu_torch.utils import precision
from tests.test_torch_models import SMALL, jax_args
from tests.test_torch_ops import relerr, rotation_deg

torch.set_num_threads(2)

JAX_ROOT = os.path.dirname(os.path.abspath(deeppointmap_tpu.__file__)) \
    + os.sep
GOVERNED = frozenset(precision.GOVERNED)
#: higher-order primitives whose sub-jaxpr the interpreter evaluates
WALKED = ("jit", "pjit", "closed_call", "custom_jvp_call", "custom_vjp_call",
          "remat2", "checkpoint")


# ------------------------------------------------------- the TPU's rule
def site(eqn):
    """'file:line' of the innermost frame of the JAX package on the
    equation's trace (relative to deeppointmap_tpu/), or None."""
    tb = eqn.source_info.traceback
    for f in (tb.frames if tb is not None else ()):
        if f.file_name.startswith(JAX_ROOT):
            return f"{f.file_name[len(JAX_ROOT):]}:{f.line_num}"
    return None


def unpinned_f32(eqn) -> bool:
    """A float32 dot_general at default precision (None or DEFAULT)."""
    if eqn.primitive.name != "dot_general":
        return False
    p = eqn.params["precision"]
    p = p if isinstance(p, tuple) else (p,)
    return all(x in (None, lax.Precision.DEFAULT) for x in p) and all(
        v.aval.dtype == jnp.float32 for v in eqn.invars)


def sub_jaxprs(eqn):
    """(jaxpr, consts) of every sub-jaxpr among the equation's params."""
    for value in eqn.params.values():
        for x in (value if isinstance(value, (tuple, list)) else (value,)):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr, x.consts
            elif isinstance(x, jcore.Jaxpr):
                yield x, ()


def dot_sites(jaxpr, out=None, inside=None) -> dict:
    """{site: {None, or the name of the unwalked primitive it sits in}} of
    every unpinned float32 dot of `jaxpr` and its sub-jaxprs."""
    out = {} if out is None else out
    for eqn in jaxpr.eqns:
        if unpinned_f32(eqn):
            out.setdefault(site(eqn), set()).add(inside)
        name = eqn.primitive.name
        for sub, _ in sub_jaxprs(eqn):
            dot_sites(sub, out, inside if name in WALKED else name)
    return out


def _round_bf16(x):
    return lax.reduce_precision(x, exponent_bits=8, mantissa_bits=7)


def eval_rule(jaxpr, consts, args):
    """Evaluate `jaxpr` with the governed dots under the TPU's rule."""
    env = {}
    read = lambda v: v.val if isinstance(v, jcore.Literal) else env[v]
    env.update(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))
    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        name = eqn.primitive.name
        if unpinned_f32(eqn) and site(eqn) in GOVERNED:
            outs = [eqn.primitive.bind(*map(_round_bf16, ins), **eqn.params)]
        elif name in WALKED:
            sub = eqn.params.get("jaxpr", eqn.params.get("call_jaxpr"))
            if isinstance(sub, jcore.ClosedJaxpr):
                outs = eval_rule(sub.jaxpr, sub.consts, ins)
            else:
                outs = eval_rule(sub, (), ins)
        else:
            for sub, _ in sub_jaxprs(eqn):
                found = dot_sites(sub)
                assert not found, (f"unpinned float32 dot inside {name} at "
                                   f"{sorted(found, key=str)}")
            outs = eqn.primitive.bind(*ins, **eqn.params)
            outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def trace(fun, *args, **kwargs):
    """jax.make_jaxpr of fun(*args, **kwargs) with unpinned dots left at
    DEFAULT (the tests' conftest pins the process default to highest)."""
    with jax.default_matmul_precision("default"):
        return jax.make_jaxpr(fun, return_shape=True)(*args, **kwargs)


def emulate(fun, static_argnames=()):
    """`fun` run under the TPU's rule, jitted; one trace a signature."""
    cache = {}

    def call(*args, **kwargs):
        static = {k: kwargs.pop(k) for k in static_argnames if k in kwargs}
        flat, tree = jax.tree.flatten((args, kwargs))
        key = (tree, tuple(sorted(static.items())),
               tuple((np.shape(x), jnp.result_type(x)) for x in flat))
        if key not in cache:
            closed, shape = trace(
                lambda a, k: fun(*a, **k, **static), args, kwargs)
            run = jax.jit(lambda *xs: eval_rule(closed.jaxpr, closed.consts,
                                                xs))
            cache[key] = run, jax.tree.structure(shape)
        run, out_tree = cache[key]
        return jax.tree.unflatten(out_tree, run(*flat))
    return call


def perturbed(params, seed: int):
    """`params` with every LayerNorm scale scaled by 1 + 0.3 N(0, 1) and
    every bias shifted by 0.1 N(0, 1), as trained weights are."""
    rng = np.random.default_rng(100 + seed)

    def perturb(path, x):
        name = getattr(path[-1], "key", "")
        x = np.asarray(x)
        if name == "scale":
            x = x * (1 + 0.3 * rng.standard_normal(x.shape))
        elif name in ("bias", "in_proj_bias"):
            x = x + 0.1 * rng.standard_normal(x.shape)
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(perturb, params)


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def normerr(a, b) -> float:
    """||a - b|| / ||b|| over every element, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ (a)
def _jax_bf16_dot(a, b):
    bf = jnp.bfloat16
    return np.asarray(jnp.matmul(jnp.asarray(a).astype(bf),
                                 jnp.asarray(b).astype(bf),
                                 preferred_element_type=jnp.float32))


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 40), k=st.integers(1, 300), n=st.integers(1, 40),
       batch=st.integers(1, 3), seed=st.integers(0, 2 ** 16))
def test_product_matches_jax_preferred_element_type(m, k, n, batch, seed):
    """linear / matmul / bmm under "bfloat16" (the plain version on the
    CPU) against jnp.matmul of bfloat16 operands with a float32 result:
    relerr <= 1e-6, K of any size (not only multiples of 16)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, m, k)).astype(np.float32)
    b = rng.normal(size=(batch, k, n)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    bf = precision.BF16
    ta, tb, tbias = _t(a, b, bias)
    want = _jax_bf16_dot(a, b)
    assert relerr(precision.bmm(ta, tb, bf).numpy(), want) <= 1e-6
    assert relerr(precision.matmul(ta[0], tb[0], bf).numpy(), want[0]) <= 1e-6
    got = precision.linear(ta, tb[0].T.contiguous(), tbias, bf).numpy()
    assert relerr(got, _jax_bf16_dot(a, b[0]) + bias) <= 1e-6
    assert precision.plain(ta, tb).dtype == torch.float32


def test_emulated_dot_rounds_only_governed_sites():
    """The emulation runs an unpinned Dense (a governed site) as the
    float32 MLP on operands rounded to bfloat16 beforehand (within a
    float32 ulp), and as the port's MLP under "bfloat16" (relerr <= 1e-6);
    it leaves a HIGHEST dot float32."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 128)).astype(np.float32)
    w = rng.normal(size=(128, 32)).astype(np.float32)
    dense = jcommon.MLP(channels=(32,))
    params = {"params": {"dense0": {"kernel": w,
                                    "bias": np.zeros(32, np.float32)},
                         "norm0": {"scale": np.ones(32, np.float32),
                                   "bias": np.zeros(32, np.float32)}}}
    closed, _ = trace(dense.apply, params, a)
    assert set(dot_sites(closed.jaxpr)) == {"models/common.py:45"}
    rounded = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                   .astype(jnp.float32))
    want = np.asarray(emulate(dense.apply)(params, a))
    params16 = jax.tree.map(lambda x: x, params)
    params16["params"]["dense0"]["kernel"] = rounded(w)
    np.testing.assert_allclose(     # jitted against eager: a float32 ulp
        want, np.asarray(dense.apply(params16, rounded(a))), rtol=1e-6,
        atol=1e-7)
    mlp = tcommon.MLP(128, [32])
    mlp.load_state_dict(state_dict_from_flax(params["params"]))
    precision.set_policy(mlp, precision.BF16)
    with torch.no_grad():
        assert relerr(mlp(torch.from_numpy(a)).numpy(), want) <= 1e-6
    pinned = emulate(lambda x, y: jnp.dot(
        x, y, precision=lax.Precision.HIGHEST))
    np.testing.assert_array_equal(np.asarray(pinned(a, w)),
                                  np.asarray(jnp.dot(a, w)))
    closed, _ = trace(lambda x, y: jnp.dot(x, y), a, w)
    assert set(dot_sites(closed.jaxpr)) == {None}   # outside the package


def test_interpreter_refuses_a_dot_it_cannot_reach():
    def body(c, x):
        return c + jnp.dot(x, x.T), None

    closed, _ = trace(lambda xs: lax.scan(body, jnp.zeros((4, 4)), xs)[0],
                      jnp.ones((3, 4, 5)))
    assert dot_sites(closed.jaxpr) == {None: {"scan"}}
    with pytest.raises(AssertionError, match="inside scan"):
        eval_rule(closed.jaxpr, closed.consts, [jnp.ones((3, 4, 5))])


# ------------------------------------------------------------------ (b)
@pytest.fixture(scope="module")
def decoders():
    """(JAX decoder, its perturbed params, the port's decoder under
    "bfloat16", the same under "unchanged") at SMALL's width."""
    _, dec, enc_p, dec_p = init_params(jax_args(), seed=3)
    dec_p = perturbed(dec_p, 3)
    sd = state_dicts_from_jax(enc_p, dec_p)[1]
    out = []
    for policy in (precision.BF16, precision.UNCHANGED):
        t = Decoder.from_config(config_from_dict(SMALL), policy)
        t.load_state_dict(sd)
        out.append(t.eval())
    return (dec, dec_p, *out)


def _descriptors(seed, n=256, c=32, n_valid=230):
    """Two descriptor sets (n, c + 3) with meter xyz, the second a moved,
    noisy copy of the first (so that registration finds pairs)."""
    rng = np.random.default_rng(seed)
    fea = rng.normal(size=(n, c)).astype(np.float32)
    xyz = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    ang = 0.2
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                    0], [0, 0, 1]])
    perm = rng.permutation(n)
    xyz2 = (xyz @ R.T + np.array([1.0, -0.5, 0.1]))[perm]
    fea2 = fea[perm] + 0.3 * rng.normal(size=(n, c))
    src = np.concatenate([fea, xyz], -1).astype(np.float32)
    dst = np.concatenate([fea2, xyz2], -1).astype(np.float32)
    sv = np.arange(n) < n_valid
    dv = rng.permutation(sv)
    return src, dst, sv, dv


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_and_attention_match_the_tpu_rule(seed):
    """MLP (two layers) and masked attention, perturbed parameters: port
    under "bfloat16" vs JAX under the emulation relerr <= 2e-5; the rule
    itself moves them >= 1e-4 from float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 40, 19)).astype(np.float32)
    jm = jcommon.MLP(channels=(48, 24))
    mp = perturbed(jm.init(jax.random.PRNGKey(seed), x), seed)
    tm = tcommon.MLP(19, [48, 24])
    tm.load_state_dict(state_dict_from_flax(mp["params"]))
    q = rng.normal(size=(2, 37, 64)).astype(np.float32)
    kv = rng.normal(size=(2, 45, 64)).astype(np.float32)
    kvalid = rng.random((2, 45)) < 0.8
    kvalid[:, 0] = True
    ja = jcommon.MultiHeadAttention(64)
    ap = perturbed(ja.init(jax.random.PRNGKey(seed), q, kv, kv, kvalid), seed)
    ta = tcommon.MultiHeadAttention(64)
    ta.load_state_dict(state_dict_from_flax(ap["params"]))
    cases = [(tm, (x,), emulate(jm.apply)(mp, x), jm.apply(mp, x)),
             (ta, (q, kv, kv, kvalid), emulate(ja.apply)(ap, q, kv, kv,
                                                         kvalid),
              ja.apply(ap, q, kv, kv, kvalid))]
    for module, inputs, want, f32 in cases:
        precision.set_policy(module, precision.BF16)
        with torch.no_grad():
            got = module(*_t(*inputs)).numpy()
        assert relerr(got, want) <= 2e-5
        assert relerr(want, f32) >= 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_decoder_heads_match_the_tpu_rule(decoders, seed):
    """Similarity, coarse pairing, offset and overlap heads: relerr <=
    5e-5. correlate (projection and attention layers): an operand that
    rounds the other way in one layer spreads through the attention to
    every token, so its features are held by norm, ||d|| / ||w|| <= 1e-3
    and <= 0.4 of what the rule moves them from float32 (~3e-3)."""
    jdec, dec_p, tdec, _ = decoders
    rng = np.random.default_rng(10 + seed)
    mc = tdec.model_channel
    x = rng.normal(size=(2, 50, mc)).astype(np.float32)
    x2 = rng.normal(size=(2, 50, 2 * mc)).astype(np.float32)
    xc = rng.normal(size=(2, 50, 32)).astype(np.float32)
    src, dst, sv, dv = _descriptors(seed, n=64)
    heads = [
        ("similarity_head", x, tdec.similarity_head),
        ("coarse_pairing_head", xc, tdec.coarse_pairing_head),
        ("offset_head", x2, tdec.offset_head),
    ]
    with torch.no_grad():
        for name, inp, module in heads:
            want = emulate(lambda p, a, n=name: JDecoder(
                **_dec_kwargs()).apply(p, a, method=lambda d, a: getattr(
                    d, n)(a)))(dec_p, inp)
            assert relerr(module(*_t(inp)).numpy(), want) <= 5e-5, name
        want = emulate(lambda p, a, b: jdec.apply(
            p, a, b, method=lambda d, a, b: d.loop_head(a, b)))(dec_p, x, x)
        assert relerr(tdec.loop_head(*_t(x, x)).numpy(), want) <= 5e-5
        want = emulate(functools.partial(jdec.apply,
                                         method=JDecoder.correlate))(
            dec_p, src[None], dst[None], sv[None], dv[None])
        inputs = _t(src[None], dst[None], sv[None], dv[None])
        got = tdec.correlate(*inputs)
        f32 = decoders[3].correlate(*inputs)
        for g, f, w in zip(got, f32, want):
            assert normerr(g.numpy(), w) <= 1e-3
            assert normerr(g.numpy(), w) <= 0.4 * normerr(f.numpy(), w)


def _dec_kwargs():
    d = SMALL["decoder"]
    return dict(in_channel=d["in_channel"], model_channel=d["model_channel"],
                attention_layers=d["attention_layers"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registration_and_loop_detection_match_the_tpu_rule(decoders, seed):
    """Registration of a moved, noisy copy (dual-softmax top-k, offsets,
    trimmed solve) and loop detection: R within 0.02 deg and closer than
    the float32 run's, t within 5 mm, confidence within 5e-3 and rmse
    within 1e-3 relative, the same inlier count, the overlap probability
    within 5e-4. (Over seeds 0-7: R <= 0.15 deg where float32 is 1.3 deg
    off, conf <= 2.2e-3, the inliers always equal, the probability
    <= 1.7e-4.)"""
    jdec, dec_p, tdec, _ = decoders
    src, dst, sv, dv = _descriptors(seed)
    k = num_pairs_for(256, 256)
    reg = emulate(functools.partial(jdec.apply, method=JDecoder.registration),
                  static_argnames=("num_pairs",))
    R, t, conf, rmse, n_in = (np.asarray(x) for x in reg(
        dec_p, src, dst, sv, dv, num_pairs=k))
    with torch.no_grad():
        tR, tt, tconf, trmse, tn = (x.numpy() for x in tdec.registration(
            *_t(src, dst, sv, dv), k))
        fR = decoders[3].registration(*_t(src, dst, sv, dv), k)[0].numpy()
    assert rotation_deg(tR, R) <= 0.02
    assert rotation_deg(tR, R) < rotation_deg(fR, R)
    assert np.linalg.norm(tt - t) <= 5e-3
    assert abs(tconf - conf) <= 5e-3 * abs(conf)
    assert abs(trmse - rmse) <= 1e-3 * abs(rmse)
    assert int(tn) == int(n_in)
    loop = emulate(functools.partial(jdec.apply,
                                     method=JDecoder.loop_detection))
    want = np.asarray(loop(dec_p, src[None], dst[None], sv[None], dv[None]))
    with torch.no_grad():
        got = tdec.loop_detection(*_t(src[None], dst[None], sv[None],
                                      dv[None])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


# ------------------------------------------------------------------ (d)
def _serving_programs():
    """[(name, closed jaxpr)] of every program of the JAX engine, with the
    device chain and without, the trimmed and the RANSAC solve."""
    from deeppointmap_tpu.data.preprocess import PreprocessConfig as JPre
    from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine

    S = jax.ShapeDtypeStruct
    f32, b_ = jnp.float32, jnp.bool_
    enc, dec, enc_p, dec_p = init_params(jax_args(), seed=1)
    k, c, p = 256, 35, 2048
    desc, kv, pcd, pv = S((k, c), f32), S((k,), b_), S((p, 3), f32), \
        S((p,), b_)
    n_act = S((), jnp.int32)
    out = []
    # every program once, the device chain's and the RANSAC solve's
    # variants of the programs they change
    for pre, robust, only in ((None, False, None),
                              (JPre.from_transforms(SMALL["transforms"]),
                               False, ("extract", "odometry")),
                              (None, True, ("register_info",))):
        if True:
            cfg = dict(SMALL, tpu=dict(SMALL["tpu"], robust_register=robust))
            args = jax_args(cfg)
            eng = JEngine(args, enc_p, dec_p, preprocess_cfg=pre)
            pts, val = S((1, p, 3), f32), S((1, p), b_)
            two = (desc, desc)

            def pairs(fn):   # num_pairs static, the actual count traced
                return lambda *a: fn(*a[:-1], num_pairs=128,
                                     num_pairs_actual=a[-1])

            progs = {
                "extract": (eng._extract_impl, (pts, val)),
                "odometry": (pairs(eng._odometry_impl),
                             (pts, val, desc, kv, pcd, pv, n_act)),
                "register": (pairs(eng._register_impl),
                             (desc, desc, kv, kv, n_act)),
                "register_info": (pairs(eng._register_info_impl),
                    (desc, desc, kv, kv, pcd, pv, pcd, pv, n_act)),
                "register_info_multi": (pairs(eng._register_info_batch_impl),
                    (two, (kv, kv), (pcd, pcd), (pv, pv), desc, kv, pcd, pv,
                     S((2,), jnp.int32))),
                "tile_register": (pairs(eng._tile_reg_info_impl),
                    (two, (kv, kv), S((2, 4, 4), f32), S((2,), b_), desc, kv,
                     pcd, pv, pcd, pv, n_act)),
                "tile_tile_register": (pairs(eng._tile_tile_reg_info_impl),
                    (two, (kv, kv), S((2, 4, 4), f32), S((2,), b_), two,
                     (kv, kv), S((2, 4, 4), f32), S((2,), b_), pcd, pv, pcd,
                     pv, n_act)),
                "loop": (eng._loop_impl, (S((2, k, c), f32),
                                          S((2, k, c), f32), S((2, k), b_),
                                          S((2, k), b_))),
                "loop_members": (eng._loop_members_impl, (two, (kv, kv),
                                                          desc, kv)),
                "info": (eng._info_impl, (pcd, pv, pcd, pv, S((3, 3), f32),
                                          S((3,), f32))),
            }
            for name, (fn, shapes) in progs.items():
                if only is not None and name not in only:
                    continue
                out.append((f"{name} pre={pre is not None} "
                            f"robust={robust}", trace(fn, *shapes)[0]))
    return out


def _training_programs():
    """[(name, closed jaxpr)] of the JAX stage-1 step (the mahalanobis
    offset loss, the only one with products; remat on, which wraps the
    encoder in a sub-jaxpr) and of the stage-2 step."""
    import optax

    from deeppointmap_tpu.models.loss import LossConfig
    from deeppointmap_tpu.parallel import train_step as jts

    enc, dec, enc_p, dec_p = init_params(jax_args(), seed=1)
    S = jax.ShapeDtypeStruct
    f32 = jnp.float32
    batch = jts.RegistrationBatch(S((1, 2, 512, 3), f32),
                                  S((1, 2, 512), jnp.bool_),
                                  S((1, 2, 4, 4), f32), S((1, 2), jnp.int32),
                                  S((1, 3, 3), f32), S((1, 3), f32))
    opt = optax.adamw(1e-3)
    state = jts.TrainState(enc_p, dec_p, opt.init((enc_p, dec_p)),
                           S((), jnp.int32))
    out = []
    step = jts.make_registration_train_step(
        enc, dec, LossConfig(offset_value="mahalanobis"), opt, max_pairs=64,
        remat=True)
    out.append(("stage1", trace(step, state, batch)[0]))
    loop = jts.LoopBatch(S((1, 512, 3), f32), S((1, 512), jnp.bool_),
                         S((1, 512, 3), f32), S((1, 512), jnp.bool_),
                         S((1,), f32))
    out.append(("stage2", trace(jts.make_loop_train_step(enc, dec, opt),
                                state, loop)[0]))
    return out


def test_site_list_is_every_unpinned_float32_product():
    """Every unpinned float32 product in the JAX package's serving and
    training programs lies at a site of precision.GOVERNED or
    precision.FLOAT32, every listed site is reached, the two lists are
    disjoint, and none sits where the interpreter cannot reach it."""
    assert not set(precision.GOVERNED) & set(precision.FLOAT32)
    found = {}
    for name, closed in _serving_programs() + _training_programs():
        for where, inside in dot_sites(closed.jaxpr).items():
            assert inside == {None}, (name, where, inside)
            found.setdefault(where, set()).add(name)
    assert None not in found, found.get(None)
    assert set(found) == set(precision.GOVERNED) | set(precision.FLOAT32), \
        sorted(set(found) ^ (set(precision.GOVERNED)
                             | set(precision.FLOAT32)))


# ------------------------------------------------------------------ (e)
def test_policy_rule_matches_the_jax_package():
    """bf16 defaults to true; false -> highest; true -> bfloat16 on a CUDA
    device, unchanged elsewhere; a forced policy wins; nothing else is a
    policy. strict_matmuls keeps TF32 off."""
    from deeppointmap_tpu_torch import kernels

    rule = precision.apply_matmul_precision
    assert rule(None, "cpu") == rule({}, "cpu") == precision.UNCHANGED
    assert rule(None, "cuda") == rule({"bf16": True}, "cuda:1") == \
        precision.BF16
    assert rule({"bf16": False}, "cuda") == rule({"bf16": False}, "cpu") == \
        precision.HIGHEST
    assert precision.resolve(precision.BF16, {"bf16": False}, "cpu") == \
        precision.BF16
    assert precision.resolve(None, {"bf16": False}, "cuda") == \
        precision.HIGHEST
    with pytest.raises(ValueError):
        precision.resolve("medium", None, "cpu")
    kernels.strict_matmuls()
    assert not torch.backends.cuda.matmul.allow_tf32
    cuda = torch.backends.cuda.matmul
    assert not cuda.allow_bf16_reduced_precision_reduction


def test_float32_policies_run_the_float32_code_bit_for_bit(decoders,
                                                           monkeypatch):
    """Under "highest" and "unchanged" no product takes the rule: the
    decoder's outputs are bit-equal to each other and to the same
    weights in plain torch layers (nn.Linear, the einsum attention)."""
    _, dec_p, tdec_bf, tdec = decoders
    monkeypatch.setattr(precision, "_rule_product", None)
    src, dst, sv, dv = _descriptors(5)
    k = num_pairs_for(256, 256)
    outs = []
    for policy in (precision.UNCHANGED, precision.HIGHEST):
        precision.set_policy(tdec, policy)
        with torch.no_grad():
            outs.append([x.numpy() for x in tdec.registration(
                *_t(src, dst, sv, dv), k)]
                + [tdec.loop_detection(*_t(src[None], dst[None], sv[None],
                                            dv[None])).numpy()])
    precision.set_policy(tdec, precision.UNCHANGED)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    x = torch.randn(7, 32)
    lin = torch.nn.Linear(32, 32)
    lin.load_state_dict(tdec.coarse_pairing_head.dense0.state_dict())
    with torch.no_grad():
        np.testing.assert_array_equal(
            tdec.coarse_pairing_head.dense0(x).numpy(), lin(x).numpy())


def test_coordinate_products_do_not_move_with_the_rule():
    """Given the same inputs, the information matrix, the tile assembly,
    the map building and the offset losses (FLOAT32 sites, which take no
    policy) are bit-equal whichever policy the models hold."""
    from deeppointmap_tpu_torch.models import loss as tloss
    from deeppointmap_tpu_torch.ops.infomat import information_matrix
    from deeppointmap_tpu_torch.parallel.train_step import _build_maps
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    rng = np.random.default_rng(0)
    pcd = torch.from_numpy(rng.uniform(-30, 30, (500, 3)).astype(np.float32))
    pv = torch.from_numpy(rng.random(500) > 0.1)
    R = torch.from_numpy(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(
        np.float32))
    t = torch.tensor([0.5, -1.0, 0.2])
    res = torch.from_numpy(rng.normal(size=(2, 40, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random((2, 40)) > 0.3)
    desc = torch.from_numpy(rng.normal(size=(1, 2, 16, 35)).astype(
        np.float32))
    dv = torch.ones(1, 2, 16, dtype=torch.bool)
    se3 = torch.eye(4).repeat(1, 2, 1, 1)
    se3[0, 1, :3, :3], se3[0, 1, :3, 3] = R, t
    gid = torch.tensor([[0, 1]])
    outs = {}
    for policy in (precision.BF16, precision.HIGHEST):
        outs[policy] = [
            information_matrix(pcd, pv, pcd, pv, R, t, stride=4),
            InferenceEngine._tile([desc[0, 0], desc[0, 1]],
                                  [dv[0, 0], dv[0, 1]], se3[0],
                                  torch.ones(2, dtype=torch.bool))[0],
            *_build_maps(desc, dv, se3, gid),
            *(tloss.offset_loss(res, valid, mode)
              for mode in ("euclidean", "manhattan", "mahalanobis"))]
    for a, b in zip(outs[precision.BF16], outs[precision.HIGHEST]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize("shape", [(5, 19, 7), (1, 33, 16), (3, 8, 1)])
def test_product_gradient_takes_the_rule(shape):
    """The autograd Function's gradients: dA = round(dY) round(B)^T and
    dB = round(A)^T round(dY) in float64 within relerr 1e-6 (the rule),
    and central finite differences of the float64 product within the
    bfloat16 rounding of two operands (relerr <= 2^-7); the bias gradient
    is the float32 column sum."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    a64 = rng.normal(size=(m, k))
    b64 = rng.normal(size=(k, n))
    g64 = rng.normal(size=(m, n))
    a = torch.tensor(a64, dtype=torch.float32, requires_grad=True)
    w = torch.tensor(b64.T, dtype=torch.float32, requires_grad=True)
    bias = torch.zeros(n, requires_grad=True)
    y = precision.linear(a, w, bias, precision.BF16)
    y.backward(torch.tensor(g64, dtype=torch.float32))
    r = lambda x: torch.tensor(x, dtype=torch.float32).to(
        torch.bfloat16).double().numpy()
    assert relerr(a.grad.numpy(), r(g64) @ r(b64).T) <= 1e-6
    assert relerr(w.grad.numpy().T, r(a64).T @ r(g64)) <= 1e-6
    np.testing.assert_allclose(bias.grad.numpy(),
                               g64.astype(np.float32).sum(0), rtol=1e-6)
    eps = 1e-3
    fd_a = np.zeros_like(a64)
    for i in np.ndindex(*a64.shape):
        d = np.zeros_like(a64)
        d[i] = eps
        fd_a[i] = (((a64 + d) @ b64 - (a64 - d) @ b64) * g64).sum() / (2 * eps)
    assert relerr(a.grad.numpy(), fd_a) <= 2 ** -7


def test_attention_gradient_matches_the_tpu_rule():
    """jax.grad of masked attention under the emulation against the port's
    backward under "bfloat16", by parameter: ||d|| / ||g|| <= 1e-4."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 21, 32)).astype(np.float32)
    kvalid = rng.random((2, 21)) < 0.8
    kvalid[:, 0] = True
    ja = jcommon.MultiHeadAttention(32)
    ap = perturbed(ja.init(jax.random.PRNGKey(0), q, q, q, kvalid), 4)
    loss = lambda p: jnp.sum(jnp.sin(ja.apply(p, q, q, q, kvalid)))
    want = emulate(jax.grad(loss))(ap)["params"]
    ta = tcommon.MultiHeadAttention(32)
    ta.load_state_dict(state_dict_from_flax(ap["params"]))
    precision.set_policy(ta, precision.BF16)
    torch.sin(ta(*_t(q, q, q, kvalid))).sum().backward()
    got = state_dict_from_flax(jax.tree.map(np.zeros_like, want))
    for name, p in ta.named_parameters():
        got[name] = p.grad
    for name, g in state_dict_from_flax(want).items():
        d = np.linalg.norm(got[name].numpy() - g.numpy())
        assert d <= 1e-4 * np.linalg.norm(g.numpy()), name
