"""The benchmark's frozen work count and peaks: a copy of the formulas of
deeppointmap_tpu_torch/utils/roofline.py that the per-layer metrics use,
as they stood when the benchmark was defined (benchmark/tests/
test_bench_frozen.py pins them to the port's). Pure Python: the counts
take the configuration's trees (`Tree`, attribute access over dicts) and
numbers the benchmark measures on its own inputs (valid points, in-radius
pairs), never the program's outputs.

Per kernel: FPS (K1) 9 FLOPs a valid point and step; kNN (K2) 8 a center
and valid point; radius moments 16 an in-radius pair. Dense: 2 M N K a
linear at its precision's rate ("rule": the tpu.bf16 rule's bfloat16
operands at the bfloat16 rate), 7 an element of LayerNorm, 5 of softmax;
attention's two products and 6 a logit. A training step counts 3x the
dense forward, FPS and kNN once. Not counted: gathers, sorts, the filters'
statistics, the Kabsch SVD, the optimizer's update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple


class Peaks(NamedTuple):
    """Published peak rates of one card."""
    f32_flops: float     # FLOP/s, float32 outside the tensor cores
    bf16_flops: float    # FLOP/s, bfloat16 dense on the tensor cores
    hbm_bytes: float     # bytes/s


#: NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
H100_SXM = Peaks(f32_flops=67e12, bf16_flops=989e12, hbm_bytes=3.35e12)
KNOWN_CARDS = {"NVIDIA H100 80GB HBM3": H100_SXM}

FLOPS_FPS = 9.0
FLOPS_PAIR = 8.0
FLOPS_MOMENTS = 16.0
FLOPS_LAYER_NORM = 7.0
FLOPS_SOFTMAX = 5.0
FLOPS_LOGIT = 1.0 + FLOPS_SOFTMAX
F32 = 4
FLOAT32, RULE, BF16_ACT = "float32", "rule", "bf16_act"
ACT_BYTES = {FLOAT32: F32, RULE: F32, BF16_ACT: 2}
#: the matmul policies of the port's utils/precision.py
BF16, HIGHEST, UNCHANGED = "bfloat16", "highest", "unchanged"
POLICIES = (BF16, HIGHEST, UNCHANGED)
#: the port's ops/kabsch.py RANSAC solve: hypotheses and refinements
RANSAC_HYPOTHESES = 1024
RANSAC_REFINES = 3
TRIM_SOLVES = 3


class Tree(dict):
    """A configuration tree with attribute access (the port's Config)."""

    def __getattr__(self, key):
        try:
            value = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return Tree(value) if isinstance(value, dict) \
            and not isinstance(value, Tree) else value


@dataclasses.dataclass(frozen=True)
class Cost:
    flops: float = 0.0         # at the float32 rate
    bytes: float = 0.0
    bf16_flops: float = 0.0    # at the bfloat16 rate
    matmul_flops: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(*(a + b for a, b in zip(dataclasses.astuple(self),
                                             dataclasses.astuple(other))))

    def __mul__(self, k: float) -> "Cost":
        return Cost(*(a * k for a in dataclasses.astuple(self)))

    @property
    def total_flops(self) -> float:
        return self.flops + self.bf16_flops

    def seconds(self, peaks: Peaks) -> tuple:
        """(the operations' seconds at the peak of each one's precision,
        the bytes' seconds at the HBM rate)."""
        return (self.flops / peaks.f32_flops
                + self.bf16_flops / peaks.bf16_flops,
                self.bytes / peaks.hbm_bytes)

    def bound(self, peaks: Peaks) -> float:
        """The least seconds the card could take."""
        return max(self.seconds(peaks))


def total(parts) -> Cost:
    parts = parts.values() if isinstance(parts, dict) else parts
    return sum(parts, Cost())


# ---------------------------------------------------------- per kernel
def fps_cost(b: int, n: int, k: int, valid_points: int) -> Cost:
    return Cost(flops=FLOPS_FPS * valid_points * max(k - 1, 0),
                bytes=b * n * 13 + b * k * 8)


def knn_cost(b: int, n: int, s: int, k: int, valid_points: int) -> Cost:
    return Cost(flops=FLOPS_PAIR * s * valid_points,
                bytes=b * n * 13 + b * s * 12 + b * s * k * 12)


def moments_cost(b: int, s: int, in_radius: int) -> Cost:
    return Cost(flops=FLOPS_MOMENTS * in_radius, bytes=b * s * 40)


# --------------------------------------------------------------- dense
def _product(mm: float, act_elems: float, weight_bytes: float,
             prec: str) -> Cost:
    if prec not in ACT_BYTES:
        raise ValueError(f"product precision {prec!r}")
    fast = prec != FLOAT32
    return Cost(flops=0.0 if fast else mm, bf16_flops=mm if fast else 0.0,
                bytes=ACT_BYTES[prec] * act_elems + weight_bytes,
                matmul_flops=mm)


def linear(rows: int, n_in: int, n_out: int, bias: bool = True,
           prec: str = FLOAT32) -> Cost:
    return _product(2.0 * rows * n_in * n_out, rows * (n_in + n_out),
                    F32 * (n_in * n_out + (n_out if bias else 0)), prec)


def matmul(m: int, k: int, n: int, batch: int = 1,
           prec: str = FLOAT32) -> Cost:
    return _product(2.0 * batch * m * n * k,
                    batch * (m * k + k * n + m * n), 0.0, prec)


def layer_norm(rows: int, c: int) -> Cost:
    return Cost(flops=FLOPS_LAYER_NORM * rows * c,
                bytes=2 * F32 * rows * c + 2 * F32 * c)


def softmax(rows: int, c: int) -> Cost:
    return Cost(flops=FLOPS_SOFTMAX * rows * c, bytes=2 * F32 * rows * c)


def mlp(rows: int, n_in: int, channels, bias: bool = True,
        prec: str = FLOAT32) -> Cost:
    out = Cost()
    for ch in channels:
        out = out + linear(rows, n_in, ch, bias, prec) + layer_norm(rows, ch)
        n_in = ch
    return out


def attention(b: int, mq: int, nk: int, c: int, heads: int,
              prec: str = FLOAT32) -> Cost:
    logits = b * heads * mq * nk
    proj = linear(b * mq, c, c, prec=prec) * 2 \
        + linear(b * nk, c, c, prec=prec) * 2
    return proj + matmul(mq, c // heads, nk, b * heads, prec) \
        + matmul(mq, nk, c // heads, b * heads, prec) \
        + Cost(flops=FLOPS_LOGIT * logits, bytes=2 * F32 * logits)


# -------------------------------------------------------------- encoder
def graph_ks(e) -> list:
    n_lv = len(e.npoint)
    out = []
    for i in range(n_lv):
        own = max(e.nsample_list[i][1:], default=0)
        nxt = e.nsample_list[i + 1][0] if i + 1 < n_lv else 0
        out.append(max(own, nxt))
    return out


def encoder_dense(e, b: int, n: int,
                  prec: str = FLOAT32) -> Dict[str, Cost]:
    bias = bool(e.get("bias", True))
    width, npoint = int(e.width), list(e.npoint)
    out = {"point_mlp0": linear(b * n, int(e.in_channel), width, True, prec)}
    widths = [width]
    for i, s in enumerate(npoint):
        c = widths[-1]
        ns = e.nsample_list[i]
        cost = mlp(b * s * ns[0], c + 3, [2 * c], bias, prec)
        for k in ns[1:len(e.radius_list[i])]:
            cost = cost + mlp(b * s * k, 2 * c + 3, [2 * c], bias, prec) \
                + mlp(b * s, 2 * c, [2 * c * int(e.expansion), 2 * c], bias,
                      prec)
        out[f"down{i}"] = cost
        widths.append(2 * c)
    n_lv = len(npoint)
    w = fea2 = widths[-1]
    for i in range(int(e.upsample_layers)):
        up = max(int(e.out_channel), w // 2)
        fea1 = widths[n_lv - i - 1]
        out[f"up{i}"] = mlp(b * npoint[n_lv - i - 2], fea1 + fea2, [up, up],
                            bias, prec)
        fea2, w = up, w // 2
    return out


def encoder_neighbours(e, n: int, valid_points, sweep_grouping: bool = False
                       ) -> Dict[str, Cost]:
    npoint, b = list(e.npoint), len(valid_points)
    lv = [list(valid_points)]
    for s in npoint:
        lv.append([min(int(s), v) for v in lv[-1]])
    sizes = [n] + npoint
    fps = total(fps_cost(b, sizes[i], npoint[i], sum(lv[i]))
                for i in range(len(npoint)))
    knn = Cost() if sweep_grouping else knn_cost(
        b, n, npoint[0], int(e.nsample_list[0][0]), sum(lv[0]))
    for i, k in enumerate(graph_ks(e)):
        if k > 0:
            knn = knn + knn_cost(b, npoint[i], npoint[i], k, sum(lv[i + 1]))
    n_lv = len(npoint)
    fp = total(knn_cost(b, npoint[n_lv - 1 - i], npoint[n_lv - 2 - i], 3,
                        sum(lv[n_lv - i]))
               for i in range(int(e.upsample_layers)))
    return {"fps": fps, "sa_level_knn": knn, "fp_3nn": fp}


def preprocess_sweep(pre, n: int, crop_valid, in_radius: int) -> Cost:
    """pre: the filter chain's settings (`normals_num`, `use_lowpass`,
    `outlier_neighbors`, `use_outlier`, `sweep_k`)."""
    k = max((pre.normals_num + 1) if pre.use_lowpass else 0,
            (pre.outlier_neighbors + 1) if pre.use_outlier else 0,
            pre.sweep_k)
    if k == 0:
        return Cost()
    b = len(crop_valid)
    cost = knn_cost(b, n, n, k, sum(crop_valid))
    if pre.use_lowpass:
        cost = cost + moments_cost(b, n, in_radius)
    return cost


# -------------------------------------------------------------- decoder
def correlate(d, b: int, m: int, n: int,
              prec: str = FLOAT32) -> Dict[str, Cost]:
    c, mc = int(d.in_channel), int(d.model_channel)
    out = {"projection": linear(b * (m + n), c, mc, prec=prec)}
    for i in range(int(d.attention_layers)):
        cost = Cost()
        for q, kv in ((m, m), (n, n), (m, n), (n, m)):
            cost = cost + attention(b, q, kv, mc, 8, prec)
        rows = b * (m + n)
        cost = cost + linear(rows, mc, mc, prec=prec) * 2 \
            + layer_norm(rows, mc) * 3
        out[f"attn{i}"] = cost
    return out


def head_mlp(rows: int, n_in: int, emb: int, prec: str = FLOAT32) -> Cost:
    return linear(rows, n_in, emb, prec=prec) \
        + linear(rows, emb, emb, prec=prec)


def offset_head(rows: int, mc: int, prec: str = FLOAT32) -> Cost:
    e = 2 * mc
    lin = lambda n_in, n_out: linear(rows, n_in, n_out, prec=prec)
    return lin(e, e // 2) + lin(e // 2, e // 4) + lin(e // 4, e // 8) \
        + lin(e, e // 8) + lin(e // 8, 3)


def kabsch_solve(k: int, batch: int = 1) -> Cost:
    return matmul(3, k, 3, batch) + matmul(3, 3, 3, batch) * 2 \
        + matmul(3, 3, 1, batch)


def kabsch_apply(k: int) -> Cost:
    return matmul(k, 3, 3)


def registration_cost(d, m: int, n: int, num_pairs: int,
                      robust: bool = False,
                      prec: str = FLOAT32) -> Dict[str, Cost]:
    mc = int(d.model_channel)
    out = correlate(d, 1, m, n, prec)
    out["similarity_head"] = head_mlp(m + n, mc, mc, prec)
    out["pairing"] = matmul(m, mc, n, prec=prec) + softmax(m, n) * 2
    out["offset_head"] = offset_head(num_pairs, mc, prec) * 2
    k = 2 * num_pairs
    if robust:
        n_hyp = RANSAC_HYPOTHESES
        solve = kabsch_solve(3, n_hyp) + Cost(
            flops=18.0 * n_hyp * k, bytes=F32 * n_hyp * k,
            matmul_flops=18.0 * n_hyp * k)
        solve = solve + (kabsch_apply(k) + kabsch_solve(k)) \
            * RANSAC_REFINES + kabsch_apply(k)
    else:
        solve = (kabsch_solve(k) + kabsch_apply(k)) * TRIM_SOLVES \
            + kabsch_apply(k)
    out["solve"] = solve
    return out


def info_matrix_cost(n: int, stride: int, dst_valid: int) -> Cost:
    s = -(-n // stride)
    return matmul(s, 3, 3) + knn_cost(1, n, s, 1, dst_valid) \
        + matmul(6, 3 * s, 6)


# ------------------------------------------------------------- programs
class ScanCounts(NamedTuple):
    """One entry a scan: valid after the distance crop, in-radius pairs of
    the low-pass filter's radius (all centers together), valid after the
    filters."""
    crop_valid: tuple
    in_radius: int
    valid: tuple


def _tokens(e) -> int:
    return int(e.npoint[len(e.npoint) - 1 - int(e.upsample_layers)])


def product_precision(policy: str, encoder_bf16: bool = False) -> str:
    if policy not in POLICIES:
        raise ValueError(f"matmul policy {policy!r}")
    if encoder_bf16:
        return BF16_ACT
    return RULE if policy == BF16 else FLOAT32


def _encoder_precision(args, policy: str) -> str:
    return product_precision(policy, bool(
        (args.get("tpu") or {}).get("encoder_bf16", False)))


def extract_cost(args, n: int, counts: ScanCounts, pre,
                 policy: str = UNCHANGED) -> Dict[str, Cost]:
    e = args.encoder
    b = len(counts.valid)
    out = {"preprocess_sweep": preprocess_sweep(
        pre, n, counts.crop_valid, counts.in_radius)}
    out.update(encoder_neighbours(e, n, counts.valid,
                                  sweep_grouping=pre.sweep_k > 0))
    out["encoder_dense"] = total(encoder_dense(
        e, b, n, _encoder_precision(args, policy)))
    return out


def register_cost(args, m: int, n_pad: int, dst_valid: int,
                  num_pairs: int, policy: str = UNCHANGED) -> Dict[str, Cost]:
    tpu = args.get("tpu") or {}
    reg = registration_cost(args.decoder, m, _tokens(args.encoder),
                            num_pairs,
                            robust=bool(tpu.get("robust_register", False)),
                            prec=product_precision(policy))
    return {"registration": total(reg),
            "info_matrix": info_matrix_cost(
                n_pad, int(tpu.get("infomat_stride", 1)), dst_valid)}


def train_step_cost(args, b: int, s: int, n: int, valid_points,
                    max_pairs: int,
                    policy: str = UNCHANGED) -> Dict[str, Cost]:
    e, d = args.encoder, args.decoder
    prec = product_precision(policy)
    c, mc = int(d.in_channel), int(d.model_channel)
    tokens = s * _tokens(e)
    out = encoder_neighbours(e, n, valid_points)
    out["encoder_dense"] = total(encoder_dense(
        e, b * s, n, _encoder_precision(args, policy))) * 3
    dec = total(correlate(d, b, tokens, tokens, prec))
    dec = dec + head_mlp(2 * b * tokens, c, c, prec) \
        + head_mlp(2 * b * tokens, mc, mc, prec) \
        + offset_head(b * max_pairs, mc, prec) * 2
    loss = Cost()
    for width in (mc, mc, c, c):
        loss = loss + matmul(tokens, width, tokens, b, prec) \
            + softmax(b * tokens, tokens)
    out["decoder_dense"] = dec * 3
    out["loss"] = loss * 3 + matmul(tokens, mc, tokens, b, prec) * 2
    return out
