"""The `tpu.bf16` matrix-product rule (port of
deeppointmap_tpu/utils/precision.py).

On its own chip the JAX package runs every float32 product that it leaves
at default precision as one bfloat16 pass with float32 accumulation when
`tpu.bf16` is true (every shipped config), and as full float32 when it is
false; off the TPU the key changes nothing. The port applies the same rule
to the products inside the network, the sites of GOVERNED below:

  "bfloat16"   operands rounded to bfloat16, exact products, float32
               sums, a float32 result (tpu.bf16: true on a CUDA device)
  "highest"    float32 (tpu.bf16: false)
  "unchanged"  float32 (tpu.bf16: true off the card, as the JAX package
               runs off the TPU)

Under "bfloat16" a product on a CUDA tensor is one cuBLAS call with
bfloat16 operands and a float32 output (`torch.mm` / `bmm` / `addmm` with
`out_dtype=torch.float32`), and raises where the card's PyTorch lacks that
call; it never falls back to the plain version or to TF32. On a CPU tensor
it is the plain version: the operands rounded to bfloat16 and multiplied
in float32 (each product of two bfloat16 values is exact in float32). The
gradient takes the same rule: dA = dY B^T and dB = A^T dY with dY rounded
to bfloat16 and the operands saved in bfloat16, as the transpose of an
unpinned dot runs on the TPU. Under the two float32 policies the callers
run the float32 code they ran before the rule existed.

The policy is not process-wide: one process may hold models on several
devices (multi-agent agents on the CPU beside a cloud on the card, the
sharded extractor, sequence-parallel engines), so the engine, the trainer
and the extractor pass it to their models (`set_policy`). TF32 stays off
(kernels.strict_matmuls).

FLOAT32 lists the products the JAX package leaves unpinned but that stay
float32 in the port: they act on x, y, z, where a coordinate normalised by
coor_scale 60 rounds by up to ~0.12 m in bfloat16 (PARITY.md measured
~0.2 m at +-60 m and a worse ATE for single-pass bfloat16 distances).
Every product the JAX package pins (HIGH / HIGHEST) stays float32 too.
"""

from __future__ import annotations

import threading

import torch
from torch.nn import functional as F

BF16 = "bfloat16"
HIGHEST = "highest"
UNCHANGED = "unchanged"
POLICIES = (BF16, HIGHEST, UNCHANGED)

#: the JAX package's unpinned float32 products inside the network (file
#: under deeppointmap_tpu/ : line, the innermost line of the package on the
#: product's trace) -> the port's product that takes the rule
GOVERNED = {
    "models/common.py:45": "models/common.MLP (Linear)",
    "models/common.py:74": "models/common.MultiHeadAttention q projection",
    "models/common.py:75": "models/common.MultiHeadAttention k projection",
    "models/common.py:76": "models/common.MultiHeadAttention v projection",
    "models/common.py:82": "models/common.MultiHeadAttention logits (bmm)",
    "models/common.py:87": "models/common.MultiHeadAttention attn.V (bmm)",
    "models/common.py:90": "models/common.MultiHeadAttention out_proj",
    "models/encoder.py:419": "models/encoder.Encoder point_mlp0",
    "models/decoder.py:51": "models/decoder.DescriptorAttentionLayer mlp0/1",
    "models/decoder.py:81": "models/decoder.OffsetHead mlp0",
    "models/decoder.py:83": "models/decoder.OffsetHead mlp1",
    "models/decoder.py:85": "models/decoder.OffsetHead mlp2",
    "models/decoder.py:86": "models/decoder.OffsetHead downsample",
    "models/decoder.py:88": "models/decoder.OffsetHead head",
    "models/decoder.py:105": "models/decoder.OverlapHead mlp0/1",
    "models/decoder.py:109": "models/decoder.OverlapHead proj0",
    "models/decoder.py:111": "models/decoder.OverlapHead proj1",
    "models/decoder.py:123": "models/decoder.HeadMLP dense0",
    "models/decoder.py:125": "models/decoder.HeadMLP dense1",
    "models/decoder.py:188": "models/decoder.Decoder.correlate projection",
    "models/decoder.py:189": "models/decoder.Decoder.correlate projection",
    "models/decoder.py:222": "models/decoder.Decoder.registration sp dp^T",
    "models/loss.py:69": "models/loss.pairing_loss logits (bmm)",
    "models/loss.py:123": "models/loss.top1_pairing_acc similarity (bmm)",
}
#: the JAX package's unpinned float32 products over x, y, z, float32 here
FLOAT32 = {
    "slam/engine.py:524": "slam/engine.InferenceEngine._tile",
    "ops/infomat.py:69": "ops/infomat.information_matrix moved",
    "data/preprocess.py:155": "data/preprocess.preprocess normal coherence",
    "models/decoder.py:297": "models/decoder.Decoder.train_forward src_gt",
    "models/decoder.py:321": "models/decoder.Decoder.train_forward "
                             "src_off_gt",
    "parallel/train_step.py:91": "parallel/train_step._build_maps",
    "parallel/train_step.py:121": "parallel/train_step.registration_metrics "
                                  "src_global",
    "models/loss.py:98": "models/loss.offset_loss mahalanobis covariance",
    "models/loss.py:111": "models/loss.offset_loss mahalanobis quadratic",
}

#: cuBLAS calls made under "bfloat16" (forward and backward), counted
#: under a lock: pipelined SLAM runs the models from several threads
_calls = {"n": 0}
_calls_lock = threading.Lock()
_ROUTE_OPS = ("aten::mm.dtype", "aten::bmm.dtype", "aten::addmm.dtype")
#: route_available's answer, asked once a process
_route: list = []


def apply_matmul_precision(tpu_cfg, device) -> str:
    """The policy of the `tpu:` tree for models on `device`, by the JAX
    package's rule: `bf16` defaults to true; false gives "highest"; true
    gives "bfloat16" on a CUDA device and "unchanged" elsewhere. Sets
    nothing process-wide."""
    bf16 = True if tpu_cfg is None else bool(tpu_cfg.get("bf16", True))
    if not bf16:
        return HIGHEST
    return BF16 if torch.device(device).type == "cuda" else UNCHANGED


def resolve(policy, tpu_cfg, device) -> str:
    """`policy` when the caller forces one (tests and chip_smoke.py run
    the rule on the CPU so), else the rule's for `tpu_cfg` on `device`."""
    if policy is None:
        return apply_matmul_precision(tpu_cfg, device)
    if policy not in POLICIES:
        raise ValueError(f"matmul policy {policy!r}: use one of {POLICIES}")
    return policy


def set_policy(module: torch.nn.Module, policy: str) -> torch.nn.Module:
    """Give every submodule of `module` that holds a governed product
    (a `matmul_policy` attribute) the policy."""
    if policy not in POLICIES:
        raise ValueError(f"matmul policy {policy!r}: use one of {POLICIES}")
    for m in module.modules():
        if hasattr(m, "matmul_policy"):
            m.matmul_policy = policy
    return module


def route_available() -> bool:
    """Whether this PyTorch has the cuBLAS products with bfloat16 operands
    and a float32 output for CUDA tensors."""
    if not _route:
        has = getattr(torch._C, "_dispatch_has_kernel_for_dispatch_key",
                      None)
        _route.append(has is not None
                      and all(has(op, "CUDA") for op in _ROUTE_OPS))
    return _route[0]


def route_calls() -> int:
    with _calls_lock:
        return _calls["n"]


def reset_route_calls() -> None:
    with _calls_lock:
        _calls["n"] = 0


def _product(a, b, bias=None):
    """bfloat16 a (..., M, K) @ b (..., K, N) [+ float32 bias (N,)] ->
    float32: cuBLAS on a CUDA tensor, the plain version on the CPU."""
    if a.is_cuda:
        if not route_available():
            raise RuntimeError(
                "tpu.bf16 on a CUDA device needs torch.mm / bmm / addmm "
                "with out_dtype (bfloat16 operands, float32 output), which "
                f"this PyTorch {torch.__version__} lacks; set tpu.bf16: "
                "false for float32")
        with _calls_lock:
            _calls["n"] += 1
        f32 = torch.float32
        if a.dim() == 2 and bias is not None:
            return torch.addmm(bias, a, b, out_dtype=f32)
        out = (torch.bmm if a.dim() == 3 else torch.mm)(a, b, out_dtype=f32)
    else:
        out = torch.matmul(a.float(), b.float())
    return out if bias is None else out + bias


class _BF16Product(torch.autograd.Function):
    """a @ b [+ bias] under "bfloat16", with its gradient under the same
    rule (the bias gradient is a float32 sum)."""

    @staticmethod
    def forward(ctx, a, b, bias):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        ctx.has_bias = bias is not None
        return _product(a16, b16, bias)

    @staticmethod
    def backward(ctx, grad):
        a16, b16 = ctx.saved_tensors
        g16 = grad.to(torch.bfloat16)
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = _product(g16, b16.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            db = _product(a16.transpose(-1, -2), g16)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            dbias = grad.reshape(-1, grad.shape[-1]).sum(dim=0)
        return da, db, dbias


def _rule_product(a, b, bias=None):
    """a @ b [+ bias] under "bfloat16": through the autograd Function when
    a gradient is to be taken, else straight to the product (the
    Function's own host time is ~15 us a call)."""
    if torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad
            or (bias is not None and bias.requires_grad)):
        return _BF16Product.apply(a, b, bias)
    return _product(a.to(torch.bfloat16), b.to(torch.bfloat16), bias)


def plain(a, b):
    """The rule's plain version of a @ b: the operands rounded to bfloat16,
    the product in float32."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def linear(x, weight, bias=None, policy: str = UNCHANGED):
    """F.linear(x, weight, bias) under `policy`."""
    if policy != BF16:
        return F.linear(x, weight, bias)
    lead = x.shape[:-1]
    y = _rule_product(x.reshape(-1, x.shape[-1]), weight.t(), bias)
    return y.reshape(*lead, weight.shape[0])


def matmul(a, b, policy: str = UNCHANGED):
    """a (M, K) @ b (K, N) under `policy`."""
    if policy != BF16:
        return a @ b
    return _rule_product(a, b)


def bmm(a, b, policy: str = UNCHANGED):
    """a (B, M, K) @ b (B, K, N) under `policy`."""
    if policy != BF16:
        return torch.bmm(a, b)
    return _rule_product(a, b)
