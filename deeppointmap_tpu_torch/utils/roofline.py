"""The port's one count of work: FLOPs and bytes of every kernel and of the
hot programs (extract, fused odometry, register with the information
matrix, the stage-1 training step), and the card's published peaks to set
them against. The counterpart of the JAX package's scripts/mfu_profile.py,
which takes XLA's cost model instead: XLA counts a `while` body once
whatever its trip count (the FPS loop's 4095 steps as one) and a Pallas
call as nothing, so its count is not one the port can be held to.

A count is a `Cost`: operations priced at the float32 rate (outside the
tensor cores: TF32 is off in the port), operations priced at the bfloat16
rate (the network's matrix products under the `tpu.bf16` rule's
"bfloat16" policy, utils/precision.py, and the encoder's under
`tpu.encoder_bf16`), bytes, and
the share of the operations that are matrix products (what
`torch.utils.flop_counter.FlopCounterMode` counts). Each kernel, layer or
product reads its inputs once and writes its outputs once. A program's
bound takes its own bytes (`io_bytes`: its inputs, weights and state read
once, its outputs written once), not the sum of its components' traffic,
which `report_row` gives apart as `unfused_gbytes`. Where the work
depends on the data, the count takes this run's numbers: valid points,
FPS steps, in-radius pairs (`ops/neighbors.in_radius_pairs`).

Per kernel:
  FPS (K1)          9 FLOPs a valid point and step (3 sub, 3 mul, 2 add,
                    1 min); an invalid point is never a candidate.
  kNN (K2)          8 FLOPs a center and valid point: |c|^2 - 2 c.p + |p|^2
                    with the squared norms taken once a point.
  radius moments    16 FLOPs an in-radius pair (6 float64 products, 10
                    float64 sums), whichever of K2, K3 or K4 forms them;
                    priced at the float32 rate, a lower bound.
  sweep (K4, K3)    every point of the scan a center: the kNN's 8 a pair;
                    K3 is the sweep with no graph out (k = 0).
Dense, at the widths the config gives:
  linear            2 M N K (the bias add is not counted) at its `prec`:
                    FLOAT32; RULE, the tpu.bf16 rule (the bfloat16 rate,
                    float32 activations read and written: the operands are
                    rounded from them); BF16_ACT, tpu.encoder_bf16 (the
                    bfloat16 rate, 2-byte activations).
                    The products over x, y, z, the solve's and the
                    information matrix's stay float32.
  attention         its two products, 2 Mq Nk C each, and 6 an element of
                    the logits (the scale and the softmax).
  LayerNorm         7 an element; softmax 5 an element.
Not counted: gathers, sorts and selections (no arithmetic), the filters'
statistics and normals, the Kabsch SVD, the optimizer's update.
"""

from __future__ import annotations

import dataclasses
import math
import re
import subprocess
from typing import Dict, NamedTuple, Optional

import torch

from deeppointmap_tpu_torch.ops import kabsch
from deeppointmap_tpu_torch.utils import precision


class Peaks(NamedTuple):
    """Published peak rates of one card."""
    f32_flops: float     # FLOP/s, float32 outside the tensor cores
    bf16_flops: float    # FLOP/s, bfloat16 dense on the tensor cores
    hbm_bytes: float     # bytes/s


#: NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
H100_SXM = Peaks(f32_flops=67e12, bf16_flops=989e12, hbm_bytes=3.35e12)
#: torch.cuda.get_device_name -> its published peaks; a card not listed
#: has none here (device_peaks raises rather than guess)
KNOWN_CARDS = {"NVIDIA H100 80GB HBM3": H100_SXM}

FLOPS_FPS = 9.0
FLOPS_PAIR = 8.0
FLOPS_MOMENTS = 16.0
FLOPS_LAYER_NORM = 7.0
FLOPS_SOFTMAX = 5.0
FLOPS_LOGIT = 1.0 + FLOPS_SOFTMAX
F32 = 4
#: a dense product's precision (`prec`): its rate and its activations'
#: bytes. FLOAT32: float32; RULE: the tpu.bf16 rule's bfloat16 operands
#: rounded from float32 activations; BF16_ACT: tpu.encoder_bf16's bfloat16
#: activations
FLOAT32, RULE, BF16_ACT = "float32", "rule", "bf16_act"
ACT_BYTES = {FLOAT32: F32, RULE: F32, BF16_ACT: 2}


@dataclasses.dataclass(frozen=True)
class Cost:
    flops: float = 0.0         # at the float32 rate
    bytes: float = 0.0
    bf16_flops: float = 0.0    # at the bfloat16 rate
    matmul_flops: float = 0.0  # of flops + bf16_flops: matrix products

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

    def bound(self, peaks: Peaks) -> tuple:
        """(least seconds the card could take, "bytes" or "operations")."""
        t_ops, t_bytes = self.seconds(peaks)
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def bound_ms(self, peaks: Peaks) -> tuple:
        seconds, by = self.bound(peaks)
        return seconds * 1e3, by


def total(parts) -> Cost:
    """The sum of the Costs in `parts` (a dict's values or an iterable)."""
    parts = parts.values() if isinstance(parts, dict) else parts
    return sum(parts, Cost())


# ------------------------------------------------------------- the card
def _uuid_hex(text: str) -> str:
    """The 32 hex digits of a GPU UUID as torch or nvidia-smi writes it
    ("GPU-xxxxxxxx-xxxx-...", or bare)."""
    found = re.search(r"[0-9a-f]{32}", text.lower().replace("-", ""))
    return found.group(0) if found else ""


def power_limit(uuid) -> str:
    """nvidia-smi's power limit of the card with this UUID (torch's
    `get_device_properties(i).uuid`): found by UUID, since torch's index
    and nvidia-smi's differ under CUDA_VISIBLE_DEVICES. Raises if no card
    of nvidia-smi's list has it."""
    want = _uuid_hex(str(uuid))
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for row in rows:
        card, _, power = row.partition(",")
        if want and _uuid_hex(card) == want:
            return power.strip()
    raise RuntimeError(f"power_limit: no card with UUID {uuid} in "
                       f"nvidia-smi's list {rows}")


def device_peaks(device) -> tuple:
    """-> (Peaks, {"name", "count", "power_limit"}) of a CUDA device, or
    (None, None) for the CPU. Raises without a card, and on a card whose
    peaks are not in KNOWN_CARDS. The power limit is nvidia-smi's reading
    for the same card (`power_limit`): the peaks are the data sheet's at
    700 W and are not scaled."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, None
    if not torch.cuda.is_available():
        raise RuntimeError("device_peaks: no CUDA device")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    if name not in KNOWN_CARDS:
        raise ValueError(f"no published peaks for {name!r}; known: "
                         f"{sorted(KNOWN_CARDS)}")
    power = power_limit(torch.cuda.get_device_properties(index).uuid)
    return KNOWN_CARDS[name], dict(name=name, count=torch.cuda.device_count(),
                                   power_limit=power)


# ---------------------------------------------------------- per kernel
def fps_cost(b: int, n: int, k: int, valid_points: int) -> Cost:
    """K1: k picks from each of b scans of n points; `valid_points` over
    the batch. Reads xyz and validity, writes int64 indices."""
    return Cost(flops=FLOPS_FPS * valid_points * max(k - 1, 0),
                bytes=b * n * 13 + b * k * 8)


def knn_cost(b: int, n: int, s: int, k: int, valid_points: int) -> Cost:
    """K2's distance pass and selection: s centers of each of b scans
    against the scan's valid points (`valid_points` over the batch). Reads
    points, validity and centers; writes int64 indices and float32 dist2."""
    return Cost(flops=FLOPS_PAIR * s * valid_points,
                bytes=b * n * 13 + b * s * 12 + b * s * k * 12)


def moments_cost(b: int, s: int, in_radius: int) -> Cost:
    """The radius moments of s centers of each of b scans over
    `in_radius` (center, valid point) pairs: cnt, s (3) and S6 (6) out."""
    return Cost(flops=FLOPS_MOMENTS * in_radius, bytes=b * s * 40)


def sweep_cost(b: int, n: int, k: int, valid_points: int) -> Cost:
    """A sweep over each of b scans with every point a center, giving k
    neighbours a point (K4's graph; k = 0 for K3's pass). Reads points and
    validity once (no separate centers)."""
    return Cost(flops=FLOPS_PAIR * n * valid_points,
                bytes=b * n * 13 + b * n * k * 12)


# --------------------------------------------------------------- dense
def _product(mm: float, act_elems: float, weight_bytes: float,
             prec: str) -> Cost:
    """mm product operations at the rate of `prec`, act_elems activations
    at its width and weight_bytes of float32 weights."""
    if prec not in ACT_BYTES:
        raise ValueError(f"product precision {prec!r}: use one of "
                         f"{tuple(ACT_BYTES)}")
    fast = prec != FLOAT32
    return Cost(flops=0.0 if fast else mm, bf16_flops=mm if fast else 0.0,
                bytes=ACT_BYTES[prec] * act_elems + weight_bytes,
                matmul_flops=mm)


def linear(rows: int, n_in: int, n_out: int, bias: bool = True,
           prec: str = FLOAT32) -> Cost:
    """One nn.Linear on `rows` rows at `prec`; its float32 weights are read
    once whatever the precision."""
    return _product(2.0 * rows * n_in * n_out, rows * (n_in + n_out),
                    F32 * (n_in * n_out + (n_out if bias else 0)), prec)


def matmul(m: int, k: int, n: int, batch: int = 1,
           prec: str = FLOAT32) -> Cost:
    """A product (batch, m, k) @ (batch, k, n) at `prec`."""
    return _product(2.0 * batch * m * n * k,
                    batch * (m * k + k * n + m * n), 0.0, prec)


def layer_norm(rows: int, c: int) -> Cost:
    return Cost(flops=FLOPS_LAYER_NORM * rows * c,
                bytes=2 * F32 * rows * c + 2 * F32 * c)


def softmax(rows: int, c: int) -> Cost:
    return Cost(flops=FLOPS_SOFTMAX * rows * c, bytes=2 * F32 * rows * c)


def mlp(rows: int, n_in: int, channels, bias: bool = True,
        prec: str = FLOAT32) -> Cost:
    """models/common.MLP: Linear + LayerNorm a layer (the LayerNorm's
    statistics in float32 either way)."""
    out = Cost()
    for ch in channels:
        out = out + linear(rows, n_in, ch, bias, prec) + layer_norm(rows, ch)
        n_in = ch
    return out


def attention(b: int, mq: int, nk: int, c: int, heads: int,
              prec: str = FLOAT32) -> Cost:
    """models/common.MultiHeadAttention: the q / k / v and output
    projections, the two products over the heads and the scaled softmax."""
    logits = b * heads * mq * nk
    proj = linear(b * mq, c, c, prec=prec) * 2 \
        + linear(b * nk, c, c, prec=prec) * 2
    return proj + matmul(mq, c // heads, nk, b * heads, prec) \
        + matmul(mq, nk, c // heads, b * heads, prec) \
        + Cost(flops=FLOPS_LOGIT * logits, bytes=2 * F32 * logits)


# -------------------------------------------------------------- encoder
def _check_encoder(e) -> None:
    samplers = {str(s["type"]) for s in e.sample}
    if not samplers <= {"fps", "fps-t3d"}:
        raise ValueError(f"the count covers the FPS sampler only (got "
                         f"{sorted(samplers)})")
    querier = str(e.get("querier", "hybrid")).lower().removesuffix("-t3d")
    if querier != "hybrid":
        raise ValueError(f"the count covers the hybrid querier only (got "
                         f"{querier!r})")


def graph_ks(e) -> list:
    """The shared level graph's k a level (models/encoder.Encoder.forward:
    the widest consumer among the level's InvResMLP blocks and the next
    stage's SetAbstraction)."""
    n_lv = len(e.npoint)
    out = []
    for i in range(n_lv):
        own = max(e.nsample_list[i][1:], default=0)
        nxt = e.nsample_list[i + 1][0] if i + 1 < n_lv else 0
        out.append(max(own, nxt))
    return out


def encoder_dense(e, b: int, n: int,
                  prec: str = FLOAT32) -> Dict[str, Cost]:
    """The encoder's linear layers and LayerNorms on b scans of n points
    at `prec`, by module: point_mlp0, down{i} (SetAbstraction and InvResMLP
    blocks), up{i} (FeaturePropagation)."""
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
    """The encoder's K1 and K2 work on scans of n points with
    `valid_points` valid each (one entry a scan): "fps" (every stage),
    "sa_level_knn" (stage 1's grouping, unless the preprocess sweep serves
    it, and the shared level graphs) and "fp_3nn"."""
    _check_encoder(e)
    npoint, b = list(e.npoint), len(valid_points)
    # valid points a scan at each level: FPS keeps min(npoint, valid)
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
    """data/preprocess's one sweep over b scans (one entry of `crop_valid`
    a scan) by filter_sweep's default route: K2 at k = the widest of the
    filters' and `sweep_k`, with the radius moments when the low-pass
    filter is on. Nothing when no filter or sweep is asked for."""
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
    """Decoder.correlate: the projection of both sides and each attention
    layer (self-attention on each side, cross-attention both ways, the
    MLP, three LayerNorms a side)."""
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
    """OffsetHead on `rows` pairs of 2 mc features."""
    e = 2 * mc
    lin = lambda n_in, n_out: linear(rows, n_in, n_out, prec=prec)
    return lin(e, e // 2) + lin(e // 2, e // 4) + lin(e // 4, e // 8) \
        + lin(e, e // 8) + lin(e // 8, 3)


def kabsch_solve(k: int, batch: int = 1) -> Cost:
    """ops/kabsch._solve_rt on `batch` sets of k pairs: the covariance,
    the reflection check, R and t."""
    return matmul(3, k, 3, batch) + matmul(3, 3, 3, batch) * 2 \
        + matmul(3, 3, 1, batch)


def kabsch_apply(k: int) -> Cost:
    return matmul(k, 3, 3)


def registration_cost(d, m: int, n: int, num_pairs: int,
                      robust: bool = False,
                      prec: str = FLOAT32) -> Dict[str, Cost]:
    """Decoder.registration, M against N tokens: correlate, the similarity
    head, the pairing product and its dual softmax, the offset head both
    ways on num_pairs pairs, and the solve over 2 num_pairs pairs (the
    trimmed one's ops/kabsch.TRIM_SOLVES solves, or the RANSAC one's
    RANSAC_HYPOTHESES hypotheses and its refinements). `prec`: the
    network's products; the solve stays float32."""
    mc = int(d.model_channel)
    out = correlate(d, 1, m, n, prec)
    out["similarity_head"] = head_mlp(m + n, mc, mc, prec)
    out["pairing"] = matmul(m, mc, n, prec=prec) + softmax(m, n) * 2
    out["offset_head"] = offset_head(num_pairs, mc, prec) * 2
    k = 2 * num_pairs
    if robust:
        n_hyp = kabsch.RANSAC_HYPOTHESES
        solve = kabsch_solve(3, n_hyp) + Cost(
            flops=18.0 * n_hyp * k, bytes=F32 * n_hyp * k,
            matmul_flops=18.0 * n_hyp * k)
        solve = solve + (kabsch_apply(k) + kabsch_solve(k)) \
            * len(kabsch.RANSAC_REFINE_TAUS) + kabsch_apply(k)
    else:
        solve = (kabsch_solve(k) + kabsch_apply(k)) * kabsch.TRIM_SOLVES \
            + kabsch_apply(k)
    out["solve"] = solve
    return out


def info_matrix_cost(n: int, stride: int, dst_valid: int) -> Cost:
    """ops/infomat.information_matrix: every stride-th of the n source
    points moved by (R, t), its 1-NN among the target's `dst_valid` valid
    points (K2, k = 1), and G^T G over 3 rows a point."""
    s = -(-n // stride)
    return matmul(s, 3, 3) + knn_cost(1, n, s, 1, dst_valid) \
        + matmul(6, 3 * s, 6)


# ------------------------------------------------------------- programs
class ScanCounts(NamedTuple):
    """This run's data-dependent numbers for the scans of one extraction:
    one entry a scan. crop_valid: valid after the distance crop (the
    preprocess sweep's points); in_radius: (center, valid point) pairs
    within the low-pass filter's radius, all centers together; valid: valid
    after the filters (the encoder's input)."""
    crop_valid: tuple
    in_radius: int
    valid: tuple


def _tokens(e) -> int:
    return int(e.npoint[len(e.npoint) - 1 - int(e.upsample_layers)])


def product_precision(policy: str, encoder_bf16: bool = False) -> str:
    """The `prec` of the network's products under the matmul `policy`;
    with encoder_bf16 (the encoder's products under tpu.encoder_bf16,
    whose operands are bfloat16 already) BF16_ACT whatever the policy."""
    if policy not in precision.POLICIES:
        raise ValueError(f"matmul policy {policy!r}: use one of "
                         f"{precision.POLICIES}")
    if encoder_bf16:
        return BF16_ACT
    return RULE if policy == precision.BF16 else FLOAT32


def _encoder_precision(args, policy: str) -> str:
    return product_precision(policy, bool(
        (args.get("tpu") or {}).get("encoder_bf16", False)))


def extract_cost(args, n: int, counts: ScanCounts, pre,
                 policy: str = precision.UNCHANGED) -> Dict[str, Cost]:
    """InferenceEngine._extract_impl on len(counts.valid) scans of n
    points: the preprocess sweep (with `pre`, the engine's
    PreprocessConfig), FPS, the SA and level-graph kNN, the FP 3-NN and
    the encoder's dense layers (at the bfloat16 rate under
    tpu.encoder_bf16, or under the engine's matmul `policy` "bfloat16")."""
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
                  num_pairs: int,
                  policy: str = precision.UNCHANGED) -> Dict[str, Cost]:
    """InferenceEngine._register_info: registration of m against the
    encoder's tokens (both the engine's buckets) on num_pairs pairs, and
    the information matrix over scans of n_pad points at
    tpu.infomat_stride (float32 whatever the `policy`)."""
    tpu = args.get("tpu") or {}
    reg = registration_cost(args.decoder, m, _tokens(args.encoder),
                            num_pairs,
                            robust=bool(tpu.get("robust_register", False)),
                            prec=product_precision(policy))
    return {"registration": total(reg),
            "info_matrix": info_matrix_cost(
                n_pad, int(tpu.get("infomat_stride", 1)), dst_valid)}


def odometry_cost(args, n: int, counts: ScanCounts, cand_tokens: int,
                  num_pairs: int, pre,
                  policy: str = precision.UNCHANGED) -> Dict[str, Cost]:
    """InferenceEngine._odometry_impl: extract one scan, then register the
    candidate (cand_tokens, its bucket) against it on num_pairs pairs with
    the information matrix over the new scan's filtered points."""
    out = extract_cost(args, n, counts, pre, policy)
    out.update(register_cost(args, cand_tokens, n, counts.valid[0],
                             num_pairs, policy))
    return out


def train_step_cost(args, b: int, s: int, n: int, valid_points,
                    max_pairs: int,
                    policy: str = precision.UNCHANGED) -> Dict[str, Cost]:
    """One stage-1 step (parallel/train_step.registration_metrics and the
    backward): b groups of s frames of n points (`valid_points`, one entry
    a frame) through the encoder, both maps of s * tokens token slots
    through Decoder.train_forward, the loss's pairing products. Backward
    counts twice the forward of everything that takes a gradient (the
    dense layers, the attention, the loss's products), whether or not
    tpu.remat recomputes the encoder; FPS and kNN take none and count
    once, as do the metric's products. Under the `policy` "bfloat16" the
    network's and the loss's products, forward and backward, are at the
    bfloat16 rate."""
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


# ------------------------------------------------------------ reporting
def io_bytes(*objs) -> int:
    """The bytes of everything in `objs`, each counted once: tensors and
    numpy arrays, modules (their parameters and buffers), and tuples,
    lists and dicts of these (a NamedTuple batch, an optimizer's state);
    anything else counts nothing. A program's bytes for its bound are
    io_bytes of its inputs, weights and state read and of its outputs
    written."""
    out = 0
    for x in objs:
        if isinstance(x, torch.nn.Module):
            out += io_bytes(*x.parameters(), *x.buffers())
        elif isinstance(x, torch.Tensor):
            out += x.numel() * x.element_size()
        elif hasattr(x, "nbytes") and hasattr(x, "dtype"):
            out += int(x.nbytes)
        elif isinstance(x, dict):
            out += io_bytes(*x.values())
        elif isinstance(x, (tuple, list)):
            out += io_bytes(*x)
    return out


def report_row(program: str, parts: Dict[str, Cost], nbytes: float,
               ms: Optional[float], peaks: Optional[Peaks],
               device: Optional[dict]) -> dict:
    """One report row: the program's count and breakdown, and with a
    device time and the card's peaks the rates and shares. `nbytes` is the
    program's own bytes (io_bytes: inputs, weights and state read once,
    outputs written once), `gbytes` in the row and the bytes of its bound;
    `unfused_gbytes` is the sum of the components' traffic, each component
    reading its inputs and writing its outputs (every layer's activations
    through memory). `mfu` is the least time the operations need at the
    peak of the precision each runs in, over the time taken; `hbm_share`
    the same for `nbytes`; `roofline_share` the larger, named by
    `bound_by`. A component's bound takes its own traffic. Without a card
    (ms or peaks None) every device field is None."""
    unfused = total(parts)
    cost = dataclasses.replace(unfused, bytes=float(nbytes))
    row = dict(program=program, gflops=cost.total_flops / 1e9,
               gbytes=cost.bytes / 1e9, unfused_gbytes=unfused.bytes / 1e9,
               matmul_gflops=cost.matmul_flops / 1e9,
               ms=None, achieved_tflops=None, mfu=None, hbm_share=None,
               roofline_share=None, bound_ms=None, bound_by=None,
               components={name: dict(gflops=p.total_flops / 1e9,
                                      gbytes=p.bytes / 1e9)
                           for name, p in parts.items()},
               device=device)
    if ms is None or peaks is None:
        return row
    sec = ms * 1e-3
    t_ops, t_bytes = cost.seconds(peaks)
    bound_s, by = cost.bound(peaks)
    row.update(ms=ms, achieved_tflops=cost.total_flops / sec / 1e12,
               mfu=t_ops / sec, hbm_share=t_bytes / sec,
               roofline_share=bound_s / sec, bound_ms=bound_s * 1e3,
               bound_by=by)
    for name, p in parts.items():
        row["components"][name]["bound_ms"], row["components"][name][
            "bound_by"] = p.bound_ms(peaks)
    return row


def shares_ok(row: dict) -> bool:
    """Every share of a measured row in (0, 1]: a share above 1 means the
    count claims more work than the card could have done."""
    shares = [row[k] for k in ("mfu", "hbm_share", "roofline_share")]
    return all(x is not None and math.isfinite(x) and 0.0 < x <= 1.0
               for x in shares)
