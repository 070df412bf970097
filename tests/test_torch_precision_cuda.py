"""The `tpu.bf16` rule's cuBLAS route (deeppointmap_tpu_torch/utils/
precision.py) on the card against its plain version, and the refusal to
run the plain version on a CUDA tensor.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine: `python -m pytest --noconftest
tests/test_torch_precision_cuda.py`.
The card cases skip without a CUDA device (cuBLAS has no CPU mode).
"""

import math

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from deeppointmap_tpu_torch.models import common
from deeppointmap_tpu_torch.models import loss as tloss
from deeppointmap_tpu_torch.utils import precision

card = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA device (the cuBLAS route runs only on the card)")


def relerr(a, b) -> float:
    a, b = (torch.as_tensor(x).double().cpu() for x in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@card
@pytest.mark.parametrize("shape", [(4096, 67, 128), (256, 256, 768),
                                   (2, 19, 3), (1, 512, 1)])
def test_cublas_route_matches_the_plain_version(shape):
    """linear / bmm and the linear's gradients as one cuBLAS call with
    bfloat16 operands and a float32 output against the plain version on
    the same inputs (the same exact products, summed in another order):
    relerr <= 1e-5; each forward and backward product counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, device="cuda", generator=g, requires_grad=True)
    w = torch.randn(n, k, device="cuda", generator=g, requires_grad=True)
    bias = torch.randn(n, device="cuda", generator=g)
    bf = precision.BF16
    precision.reset_route_calls()
    y = precision.linear(a, w, bias, bf)
    assert y.dtype == torch.float32 and precision.route_calls() == 1
    want = precision.plain(a.detach(), w.detach().t()) + bias
    assert relerr(y.detach(), want) <= 1e-5
    dy = torch.randn(m, n, device="cuda", generator=g)
    y.backward(dy)
    assert precision.route_calls() == 3
    assert relerr(a.grad, precision.plain(dy, w.detach())) <= 1e-5
    assert relerr(w.grad, precision.plain(dy.t(), a.detach())) <= 1e-5
    ab = a.detach().reshape(1, m, k).repeat(2, 1, 1)
    wb = w.detach().t().reshape(1, k, n).repeat(2, 1, 1)
    assert relerr(precision.bmm(ab, wb, bf), precision.plain(ab, wb)) <= 1e-5


@pytest.mark.cuda
@card
def test_attention_on_the_card_matches_the_cpu():
    """Masked attention (8 heads, 256 tokens, the decoder's width) under
    "bfloat16", forward and backward, on the card against the CPU's plain
    version from the same weights: the output and every gradient within
    ||d|| / ||g|| <= 1e-2 and at most half of what the rule moves them
    from float32 on the CPU. (Not closer: an operand a float32 ulp from a
    bfloat16 boundary rounds the other way on one side, and the attention
    spreads it; one layer on an NVIDIA H100 read 1.6e-4 in norm.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    att = common.MultiHeadAttention(256)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 256, 256)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 200, 256)).astype(np.float32))
    valid = torch.from_numpy(rng.random((1, 200)) < 0.9)
    out = {}
    for dev, policy in (("cuda", precision.BF16), ("cpu", precision.BF16),
                        ("cpu", precision.HIGHEST)):
        mod = precision.set_policy(common.MultiHeadAttention(256), policy)
        mod.load_state_dict(att.state_dict())
        mod.to(dev)
        y = mod(q.to(dev), kv.to(dev), kv.to(dev), valid.to(dev))
        torch.sin(y).sum().backward()
        out[dev, policy] = [y.detach().cpu()] + [p.grad.cpu()
                                                 for p in mod.parameters()]
    norm = lambda a, b: float((a - b).norm() / b.norm())
    for card, cpu, f32 in zip(out["cuda", precision.BF16],
                              out["cpu", precision.BF16],
                              out["cpu", precision.HIGHEST]):
        assert norm(card, cpu) <= min(1e-2, 0.5 * norm(f32, cpu))


DEVICES = ["cpu", pytest.param("cuda", marks=[pytest.mark.cuda, card])]


def einsum_attention(att, q, k, v, key_valid):
    """The float32 attention as the port wrote it before the rule: einsums
    over (B, N, H, d) views."""
    b, n_q, c = q.shape
    n_k, h = k.shape[1], att.num_heads
    d = c // h
    w, bias = att.in_proj_weight, att.in_proj_bias
    q_p = F.linear(q, w[:c], bias[:c]).reshape(b, n_q, h, d)
    k_p = F.linear(k, w[c:2 * c], bias[c:2 * c]).reshape(b, n_k, h, d)
    v_p = F.linear(v, w[2 * c:], bias[2 * c:]).reshape(b, n_k, h, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q_p, k_p) / math.sqrt(d)
    logits = torch.where(key_valid[:, None, None, :], logits,
                         torch.full_like(logits, -1e9))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v_p).reshape(b, n_q, c)
    return F.linear(out, att.out_proj.weight, att.out_proj.bias)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("policy", [precision.HIGHEST, precision.UNCHANGED])
def test_float32_attention_and_cosine_keep_their_bits(device, policy):
    """Under the float32 policies the attention's and the loss's batched
    products (torch.bmm on contiguous operands) give the einsum forms'
    results bit for bit, forward and backward, at the decoder's width
    (256 tokens against 200, 8 heads) and at training's two frames of
    1024 tokens; TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    for b, n_q, n_k, c in ((1, 256, 200, 256), (2, 1024, 1024, 128)):
        att = common.MultiHeadAttention(c)
        with torch.no_grad():
            att.in_proj_bias.normal_()
        att = precision.set_policy(att, policy).to(device)
        x = [torch.from_numpy(rng.normal(size=(b, n, c)).astype(
            np.float32)).to(device).requires_grad_() for n in (n_q, n_k)]
        valid = torch.from_numpy(rng.random((b, n_k)) < 0.9).to(device)
        valid[:, 0] = True
        outs = []
        for fn in (att, lambda *a: einsum_attention(att, *a)):
            y = fn(x[0], x[1], x[1], valid)
            grads = torch.autograd.grad(torch.sin(y).sum(),
                                        [*x, *att.parameters()])
            outs.append([y, *grads])
        for got, want in zip(*outs):
            assert torch.equal(got, want)
        a, d = (F.normalize(t.detach(), dim=-1) for t in x)
        assert torch.equal(
            tloss._cosine(x[0].detach(), x[1].detach(), policy),
            torch.einsum("bsc,bdc->bsd", a, d))


@pytest.mark.parametrize("device", DEVICES)
def test_batched_product_with_a_bias(device):
    """A (B, M, K) @ (B, K, N) product with a bias under "bfloat16" adds
    the bias on the card as on the CPU, and its gradient is the column sum
    over every batch and row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(2)
    a = torch.randn(3, 33, 40, generator=g).to(device).requires_grad_()
    b = torch.randn(3, 40, 24, generator=g).to(device)
    bias = torch.randn(24, generator=g).to(device).requires_grad_()
    y = precision._rule_product(a, b, bias)
    assert relerr(y.detach(), precision.plain(a.detach(), b) + bias.detach()) \
        <= 1e-5
    dy = torch.randn(3, 33, 24, generator=g).to(device)
    y.backward(dy)
    assert relerr(bias.grad, dy.sum(dim=(0, 1))) <= 1e-6
    assert relerr(a.grad, precision.plain(dy, b.transpose(1, 2))) <= 1e-5


def test_cuda_tensor_without_the_route_raises(monkeypatch):
    """Under "bfloat16" a CUDA tensor takes the cuBLAS route or raises;
    it never computes the plain version."""
    monkeypatch.setattr(precision, "route_available", lambda: False)
    a = torch.zeros(2, 3, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(RuntimeError, match="out_dtype"):
        precision._product(a, a.t())
