"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the packed-attention forward (rate 0 and with Philox dropout) and backward
(both in both designs in bf16: tensor cores and CUDA cores), the
flash-attention forward and backward (any length), the head-major
single-tile attention forward and backward (both designs too), the mask
identity of each forward/backward pair (V = identity), the fused residual
dropout forward and backward, bit for bit, with its mask identity (x = 1,
residual = 0), its "wide" and "narrow" designs bit for bit with each
other, the fused FFN + LayerNorm in its "cluster" and "tile32"
designs, and the frozen-weight int8 GEMMs (cuBLASLt's ``torch._int_mm``)
bit for bit with the CPU.  Without a card: a failing launch of each new kernel is shown to
raise (a launch stubbed to return a CUDA error), and the packed and
head-major forward and backward, the fused FFN and the fused dropout
follow their design rule, count launches by design and refuse a forced
design the rule does not take.

This file imports nothing of JAX, so it also runs where only PyTorch is
installed; the `gpu` tests skip without a CUDA device.  On a machine with
the card (which has no JAX for `tests/conftest.py` to import):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels.py
"""

import contextlib
import ctypes
import functools
import re
import types

import numpy as np
import pytest
import torch

from m3p_tpu_torch.ops import _build
from m3p_tpu_torch.ops import attention as attention_ops
from m3p_tpu_torch.ops import dropout as dropout_ops
from m3p_tpu_torch.ops import fused_ffn as fused_ffn_ops
from m3p_tpu_torch.ops import quant as quant_ops
from m3p_tpu_torch.ops.attention import (
    attention_flash, attention_flash_bwd_reference, attention_flash_reference,
    attention_packed, attention_packed_bwd_reference,
    attention_bhsd, attention_packed_reference, small_attention,
    small_attention_bwd_reference, small_attention_reference)
from m3p_tpu_torch.ops.dropout import (
    dropout_add, dropout_add_reference, dropout_scale,
    dropout_scale_reference)
from m3p_tpu_torch.ops.fused_ffn import fused_ffn_ln, reference_ffn_ln
from m3p_tpu_torch.ops.philox import keep_mask_flat, keep_mask_tiles

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# gradients: fp32 sums over up to 512 rows or keys, taken in another order
TOL_BWD = dict(rtol=1e-4, atol=1e-5)
# the kernel and the plain version each round p and o (p, ds and the
# gradients in the backward) to bf16 once
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)
RATE = 0.1
SEED = 0x1234_5678_9ABC_DEF0

# (B, H, Dh, Sq, Sk, lengths of the key mask, causal); the CPU parity tests
# against the JAX package use the same cases
CASES = [
    (2, 3, 16, 40, 40, (40, 17), False),
    (2, 3, 16, 40, 40, (40, 17), True),
    (2, 3, 16, 10, 37, (37, 20), False),
    (2, 3, 16, 10, 37, (37, 20), True),
    (3, 2, 8, 24, 24, (24, 9, 1), False),
]
# the serving shapes: encoder blocks at 100 regions + a 64-token bucket,
# the refiner at 100 regions; a batch-padding row with no valid key
SERVING_CASES = [
    (4, 12, 64, 164, 164, (164, 0, 101, 37), False),
    (4, 12, 64, 100, 100, (100, 0, 55, 1), False),
]


# flash cases: several 64-row/64-key tiles, ragged last tiles, Sq != Sk
# (the causal diagonal offset both ways), a row with no valid key, Dh 16,
# 64 and 128; the CPU parity tests against the JAX package use them too
FLASH_CASES = [
    (2, 2, 16, 200, 200, (200, 71), False),
    (2, 2, 16, 200, 200, (200, 71), True),
    (2, 2, 16, 70, 300, (300, 129), True),
    (2, 2, 16, 300, 70, (70, 0), True),
    (2, 3, 64, 130, 577, (577, 0), False),
    (1, 2, 128, 96, 160, (160,), True),
]
# the long-context step: B = 8, S = 2048, 12 heads of 64, every key valid
XMLM_CASE = (8, 12, 64, 2048, 2048, (2048,) * 8, False)
# a bf16 shape the tensor-core design does not take (Dh 24)
FLASH_CUDA_CORES_CASE = (2, 2, 24, 150, 260, (260, 90), True)
# a decode step's self-attention over its cache: B * K = 80 rows of one
# query against S_max = 514 cached positions (two past the last full
# 64-key tile), the key mask ending after the filled positions: one valid
# key, a block edge, the ragged last block, all of them
DECODE_CASE = (80, 12, 64, 1, 514)
DECODE_FILLED = [1, 64, 513, 514]


def flash_design(dtype, dh):
    """The design of the flash kernels, and of the packed and head-major
    backward (S <= 512), that a case's fresh, contiguous tensors take: the
    tensor cores for bf16 with Dh a multiple of 16, else CUDA cores."""
    return ("tensor_cores" if dtype == torch.bfloat16 and dh % 16 == 0
            else "cuda_cores")


def _design_launches():
    return (dict(attention_flash.launches_by_design),
            dict(attention_flash.bwd_launches_by_design))


def _assert_design_rose(before, design, fwd, bwd):
    """Since ``before``, ``fwd`` forward and ``bwd`` backward launches, all
    of ``design``."""
    after = _design_launches()
    want = [{d: c[d] + (n if d == design else 0) for d in c}
            for c, n in zip(before, (fwd, bwd))]
    assert list(after) == want, (after, want)


def packed_inputs(b, h, dh, sq, sk, lens, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h * dh).astype(np.float32)
    k = rng.randn(b, sk, h * dh).astype(np.float32)
    v = rng.randn(b, sk, h * dh).astype(np.float32)
    mask = np.arange(sk)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, mask


def output_grad(b, h, dh, sq, seed=1):
    return np.random.RandomState(seed).randn(b, sq, h * dh).astype(
        np.float32)


def check_mask_identity(device, rate=0.25, seed=SEED, attn=attention_packed,
                        s=64, dtype=torch.float32, causal=False, dh=None):
    """V = identity: with v = I per head the forward's output is
    inv * keep . p, so its zeros are the keep mask; with dO = I the
    backward's dv^T is the same matrix.  Checks both against the Philox
    mask of the plain version, the keep rate and the 1/(1 - rate) scale,
    through ``attn`` (`attention_packed` or `attention_flash`) on
    ``device``, at S = ``s`` keys (at most 128), ``causal`` or not, in
    ``dtype`` (bf16 values are held to TOL_BF16: the output and dv round p
    at other places).  The head dim is ``dh`` (default S; at least S): the
    identity fills a head's first S columns and the rest are zero."""
    tol = TOL if dtype == torch.float32 else TOL_BF16
    b, h = 2, 2
    dh = dh or s
    lens = (s, s * 5 // 8)
    q, k, _, mask = packed_inputs(b, h, dh, s, s, lens, seed=7)
    eye = np.zeros((b, s, h, dh), np.float32)
    eye[:, np.arange(s), :, np.arange(s)] = 1.0
    eye = eye.reshape(b, s, h * dh)
    q, k, v, do = (torch.from_numpy(a).to(device, dtype)
                   for a in (q, k, eye, eye))
    mask = torch.from_numpy(mask).to(device)
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    out = attn(q, k, v, mask, h, causal=causal, dropout_rate=rate,
               dropout_seed=seed)
    _, _, dv = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        plain = attn(q, k, v, mask, h, causal=causal)
    # (b, h, query, key)
    out_h = out.detach().view(b, s, h, dh)[..., :s].permute(0, 2, 1, 3)
    dv_h = dv.view(b, s, h, dh)[..., :s].permute(0, 2, 3, 1)
    plain_h = plain.view(b, s, h, dh)[..., :s].permute(0, 2, 1, 3)
    keep = keep_mask_tiles(seed, b * h, s, s, rate, device).view(b, h, s, s)
    attended = mask[:, None, None, :].expand(b, h, s, s)
    if causal:
        tri = torch.ones(s, s, dtype=torch.bool, device=device).tril()
        attended = attended & tri
    kept = out_h != 0
    assert torch.equal(kept, keep & attended)       # forward vs Philox
    assert torch.equal(dv_h != 0, kept)             # backward vs forward
    torch.testing.assert_close(dv_h, out_h, **tol)
    torch.testing.assert_close(out_h[kept], plain_h[kept] / (1.0 - rate),
                               **tol)
    n = int(attended.sum())
    share = float(kept.sum()) / n
    sd = (rate * (1.0 - rate) / n) ** 0.5
    assert abs(share - (1.0 - rate)) < 5 * sd, share
    # each head draws its own mask
    assert not torch.equal(kept[0, 0], kept[0, 1])
    return share


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(device, arrays, dtype=torch.float32):
    q, k, v, mask = (torch.from_numpy(a).to(device) for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", CASES + SERVING_CASES)
def test_packed_attention_kernel_matches_plain_version(cuda_device, b, h, dh,
                                                       sq, sk, lens, causal):
    q, k, v, mask = _on(cuda_device, packed_inputs(b, h, dh, sq, sk, lens))
    before = attention_packed.launches
    got = attention_packed(q, k, v, mask, h, causal=causal)
    torch.cuda.synchronize()
    assert attention_packed.launches == before + 1
    want = attention_packed_reference(q, k, v, mask, h, causal=causal)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", SERVING_CASES)
def test_packed_attention_kernel_bf16_at_serving_shapes(cuda_device, b, h, dh,
                                                        sq, sk, lens, causal):
    q, k, v, mask = _on(cuda_device, packed_inputs(b, h, dh, sq, sk, lens),
                        torch.bfloat16)
    got = attention_packed(q, k, v, mask, h, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    want = attention_packed_reference(q, k, v, mask, h, causal=causal)
    torch.testing.assert_close(got, want, **TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["packed", "flash", "small"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_call_over_some_heads_draws_their_slice_on_the_card(
        cuda_device, entry, dtype):
    """The Philox head offset of kernels #1-#6: a call over heads 6-11 of 12
    (head_base 6, heads_total 12) at rate 0.3 gives bitwise the slice of
    the call over all 12 heads, its output and its gradients (a tensor-
    parallel rank's heads draw what one process draws for them), and the
    kernel agrees with its plain version at those arguments."""
    b, s, h, dh, rate, seed = 2, 40, 12, 64, 0.3, 4242
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, s, h * dh, device="cuda", generator=g
                               ).to(dtype) for _ in range(4))
    mask = torch.arange(s, device="cuda")[None] < torch.tensor(
        [[s], [29]], device="cuda")
    cols = slice(6 * dh, 12 * dh)
    half = dict(head_base=6, heads_total=12)

    def run(qq, kk, vv, dd, heads, **kw):
        qq, kk, vv = (t.detach().requires_grad_() for t in (qq, kk, vv))
        if entry == "small":
            split = [t.view(b, s, heads, dh).transpose(1, 2)
                     for t in (qq, kk, vv, dd)]
            out = attention_ops.small_attention(
                *split[:3], mask, dropout_rate=rate, dropout_seed=seed,
                **kw)
            out.backward(split[3])
            out = out.transpose(1, 2).reshape(b, s, heads * dh)
        else:
            fn = (attention_ops.attention_packed if entry == "packed"
                  else attention_ops.attention_flash)
            out = fn(qq, kk, vv, mask, heads, dropout_rate=rate,
                     dropout_seed=seed, **kw)
            out.backward(dd)
        return [out.detach(), qq.grad, kk.grad, vv.grad]

    whole = run(q, k, v, do, h)
    part = run(q[..., cols], k[..., cols], v[..., cols], do[..., cols], 6,
               **half)
    torch.cuda.synchronize()
    for a, c in zip(whole, part):
        assert torch.equal(a[..., cols], c)
    if entry != "small":
        plain = (attention_ops.attention_packed_reference
                 if entry == "packed" else
                 attention_ops.attention_flash_reference)(
            q[..., cols], k[..., cols], v[..., cols], mask, 6, False, None,
            rate, seed, **half)
        torch.testing.assert_close(part[0], plain,
                                   **(TOL if dtype == torch.float32
                                      else TOL_BF16))


def _grad_inputs(device, case, dtype):
    b, h, dh, sq, sk, lens, causal = case
    q, k, v, mask = _on(device, packed_inputs(b, h, dh, sq, sk, lens), dtype)
    do = torch.from_numpy(output_grad(b, h, dh, sq)).to(device).to(dtype)
    return q, k, v, mask, do


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", CASES + SERVING_CASES)
def test_packed_attention_kernel_with_dropout_matches_plain_version(
        cuda_device, b, h, dh, sq, sk, lens, causal):
    q, k, v, mask = _on(cuda_device, packed_inputs(b, h, dh, sq, sk, lens))
    got = attention_packed(q, k, v, mask, h, causal=causal,
                           dropout_rate=RATE, dropout_seed=SEED)
    torch.cuda.synchronize()
    want = attention_packed_reference(q, k, v, mask, h, causal=causal,
                                      dropout_rate=RATE, dropout_seed=SEED)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", CASES + SERVING_CASES)
def test_packed_attention_bwd_kernel_matches_plain_version(cuda_device, case,
                                                           rate):
    q, k, v, mask, do = _grad_inputs(cuda_device, case, torch.float32)
    h, causal = case[1], case[-1]
    seed = SEED if rate else None
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    out = attention_packed(q, k, v, mask, h, causal=causal,
                           dropout_rate=rate, dropout_seed=seed)
    before = attention_packed.bwd_launches
    by_design = dict(attention_packed.bwd_launches_by_design)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert attention_packed.bwd_launches == before + 2
    _assert_rose(attention_packed.bwd_launches_by_design, by_design,
                 "cuda_cores", 2)
    want = attention_packed_bwd_reference(q.detach(), k.detach(), v.detach(),
                                          mask, do, h, causal=causal,
                                          dropout_rate=rate,
                                          dropout_seed=seed)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL_BWD)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", SERVING_CASES)
def test_packed_attention_bwd_kernel_bf16_at_training_shapes(cuda_device,
                                                             case, rate):
    q, k, v, mask, do = _grad_inputs(cuda_device, case, torch.bfloat16)
    h = case[1]
    seed = SEED if rate else None
    got = attention_packed_bwd_reference(q, k, v, mask, do, h,
                                         dropout_rate=rate,
                                         dropout_seed=seed)
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    out = attention_packed(q, k, v, mask, h, dropout_rate=rate,
                           dropout_seed=seed)
    kernel = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    for g, w in zip(kernel, got):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **TOL_BF16)


# the packed and head-major backward in bf16, in both designs: the
# training shapes (B = 80; encoder blocks at S = 164, the refiner at
# S = 100) with a batch row that has no valid key, causal, Sq != Sk both
# ways (the second with an empty row), the S = 512 edge at Dh 64 and 128,
# Dh 128 with a ragged last tile
BWD_BF16_CASES = [
    (80, 12, 64, 164, 164, (164, 0) + (100,) * 78, False),
    (80, 12, 64, 100, 100, (100, 0) + (55,) * 78, False),
    (2, 3, 16, 40, 40, (40, 17), True),
    (2, 3, 16, 10, 37, (37, 20), True),
    (2, 2, 32, 37, 10, (10, 0), True),
    (2, 4, 64, 512, 512, (512, 300), False),
    (2, 4, 128, 512, 512, (512, 300), True),
    (1, 2, 128, 96, 160, (160,), True),
]


def _assert_rose(counts, before, design, n):
    """``counts`` rose by ``n``, all of ``design``, since ``before``."""
    want = {d: before[d] + (n if d == design else 0) for d in before}
    assert counts == want, (counts, want)


def packed_bwd_pair(q, k, v, mask, do, h, causal, rate, design):
    """(kernel dq/dk/dv, plain dq/dk/dv) of the packed backward: through
    autograd (the design the rule names, asserted) or, with ``design``
    "cuda_cores", the private launcher forced to it."""
    seed = SEED if rate else None
    want = attention_packed_bwd_reference(q, k, v, mask, do, h, causal, None,
                                          rate, seed)
    before = dict(attention_packed.bwd_launches_by_design)
    if design is None:
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_packed(*leaves, mask, h, causal=causal,
                               dropout_rate=rate, dropout_seed=seed)
        got = torch.autograd.grad(out, leaves, do)
    else:
        got = attention_ops._launch_bwd(q, k, v, mask, do, h, causal,
                                        (q.shape[-1] // h) ** -0.5, rate,
                                        seed, design)
    torch.cuda.synchronize()
    _assert_rose(attention_packed.bwd_launches_by_design, before,
                 design or flash_design(q.dtype, q.shape[-1] // h), 2)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("design", [None, "cuda_cores"])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", BWD_BF16_CASES)
def test_packed_attention_bwd_kernel_bf16_in_both_designs(cuda_device, case,
                                                          rate, design):
    """bf16 through the design the rule names (the tensor cores at these
    shapes) and forced to CUDA cores, each against the plain backward."""
    q, k, v, mask, do = _grad_inputs(cuda_device, case, torch.bfloat16)
    got, want = packed_bwd_pair(q, k, v, mask, do, case[1], case[-1], rate,
                                design)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_packed_attention_bwd_tensor_cores_are_deterministic(cuda_device,
                                                             rate):
    """No atomics: two calls give bitwise the same dq, dk and dv."""
    q, k, v, mask, do = _grad_inputs(cuda_device, BWD_BF16_CASES[0],
                                     torch.bfloat16)
    first, _ = packed_bwd_pair(q, k, v, mask, do, 12, False, rate, None)
    second, _ = packed_bwd_pair(q, k, v, mask, do, 12, False, rate, None)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_draw_the_plain_versions_mask(cuda_device, dtype):
    """Through the design the rule names in both directions (the tensor
    cores in bf16): two forward launches (with dropout, plain), one
    backward."""
    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    check_mask_identity(cuda_device, dtype=dtype)
    _assert_rose(attention_packed.launches_by_design, before[0],
                 flash_design(dtype, 64), 2)
    _assert_rose(attention_packed.bwd_launches_by_design, before[1],
                 flash_design(dtype, 64), 2)


def _flash_grad_check(device, case, dtype, rate, tol):
    """The flash backward kernel against the plain backward, fed the
    kernel forward's own output and statistics."""
    q, k, v, mask, do = _grad_inputs(device, case, dtype)
    h, causal = case[1], case[-1]
    seed = SEED if rate else None
    for t in (q, k, v):
        t.requires_grad_(True)
    out = attention_flash(q, k, v, mask, h, causal=causal,
                          dropout_rate=rate, dropout_seed=seed)
    before = attention_flash.bwd_launches
    by_design = _design_launches()
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert attention_flash.bwd_launches == before + 2
    _assert_design_rose(by_design, flash_design(dtype, case[2]), 0, 2)
    _, stats = attention_flash_reference(q.detach(), k.detach(), v.detach(),
                                         mask, h, causal, None, rate, seed,
                                         return_stats=True)
    want = attention_flash_bwd_reference(q.detach(), k.detach(), v.detach(),
                                         mask, out.detach(), stats, do, h,
                                         causal, None, rate, seed)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_version(cuda_device, b, h, dh,
                                                      sq, sk, lens, causal,
                                                      rate, dtype):
    q, k, v, mask = _on(cuda_device, packed_inputs(b, h, dh, sq, sk, lens),
                        dtype)
    seed = SEED if rate else None
    before = attention_flash.launches
    by_design = _design_launches()
    got = attention_flash(q, k, v, mask, h, causal=causal, dropout_rate=rate,
                          dropout_seed=seed)
    torch.cuda.synchronize()
    assert attention_flash.launches == before + 1
    _assert_design_rose(by_design, flash_design(dtype, dh), 1, 0)
    want = attention_flash_reference(q, k, v, mask, h, causal, None, rate,
                                     seed)
    torch.testing.assert_close(got, want,
                               **(TOL if dtype == torch.float32
                                  else TOL_BF16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_bwd_kernel_matches_plain_version(cuda_device, case,
                                                          rate, dtype):
    _flash_grad_check(cuda_device, case, dtype, rate,
                      TOL_BWD if dtype == torch.float32 else TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_flash_attention_kernels_bf16_on_cuda_cores(cuda_device, rate):
    """A bf16 head dim the tensor-core design does not take (24) runs the
    CUDA-core design in both directions."""
    b, h, dh, sq, sk, lens, causal = FLASH_CUDA_CORES_CASE
    q, k, v, mask = _on(cuda_device, packed_inputs(b, h, dh, sq, sk, lens),
                        torch.bfloat16)
    seed = SEED if rate else None
    by_design = _design_launches()
    got = attention_flash(q, k, v, mask, h, causal=causal, dropout_rate=rate,
                          dropout_seed=seed)
    torch.cuda.synchronize()
    _assert_design_rose(by_design, "cuda_cores", 1, 0)
    want = attention_flash_reference(q, k, v, mask, h, causal, None, rate,
                                     seed)
    torch.testing.assert_close(got, want, **TOL_BF16)
    _flash_grad_check(cuda_device, FLASH_CUDA_CORES_CASE, torch.bfloat16,
                      rate, TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_flash_attention_kernels_bf16_at_the_long_context_shape(cuda_device,
                                                                rate):
    b, h, dh, sq, sk, lens, causal = XMLM_CASE
    q, k, v, mask = _on(cuda_device, packed_inputs(b, h, dh, sq, sk, lens),
                        torch.bfloat16)
    seed = SEED if rate else None
    by_design = _design_launches()
    got = attention_flash(q, k, v, mask, h, dropout_rate=rate,
                          dropout_seed=seed)
    torch.cuda.synchronize()
    _assert_design_rose(by_design, "tensor_cores", 1, 0)
    want = attention_flash_reference(q, k, v, mask, h, False, None, rate, seed)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL_BF16)
    _flash_grad_check(cuda_device, XMLM_CASE, torch.bfloat16, rate, TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("filled", DECODE_FILLED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_the_decode_shape(cuda_device, dtype,
                                                    filled):
    """#5 at Sq = 1 against the plain version, in the packed layout and
    through the head-major entry the decode cache branch calls
    (`attention_bhsd` at rate 0 takes the flash kernel from 512 keys):
    fp32 on CUDA cores, bf16 on the tensor cores."""
    b, h, dh, sq, sk = DECODE_CASE
    q, k, v, mask = _on(cuda_device,
                        packed_inputs(b, h, dh, sq, sk, (filled,) * b), dtype)
    by_design = _design_launches()
    got = attention_flash(q, k, v, mask, h)
    torch.cuda.synchronize()
    _assert_design_rose(by_design, flash_design(dtype, dh), 1, 0)
    want = attention_flash_reference(q, k, v, mask, h)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **tol)
    qh, kh, vh = (t.view(b, t.shape[1], h, dh).transpose(1, 2)
                  for t in (q, k, v))
    by_design = _design_launches()
    got_h = attention_bhsd(qh, kh.contiguous(), vh.contiguous(), mask)
    torch.cuda.synchronize()
    _assert_design_rose(by_design, flash_design(dtype, dh), 1, 0)
    torch.testing.assert_close(got_h.transpose(1, 2).reshape(b, sq, h * dh),
                               want, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_draw_the_plain_versions_mask(cuda_device, dtype):
    by_design = _design_launches()
    check_mask_identity(cuda_device, attn=attention_flash, s=96, dtype=dtype)
    _assert_design_rose(by_design, flash_design(dtype, 96), 2, 2)


# fused residual dropout: odd sizes (not a multiple of 4, of 128 or of a
# block), a tiny one, and the MCT step's residual (80 x 164 x 768)
DROPOUT_SHAPES = [(4, 33, 130), (1001,), (3, 7), (80, 164, 768)]


def check_fused_dropout_mask_identity(device, n=40_003, rate=0.25,
                                      seed=SEED):
    """x = 1 and residual = 0: the forward's output is the keep mask times
    the scale, and the gradient of its sum by x (the backward kernel) is
    the same; both equal the plain version's Philox mask.  Returns the keep
    share."""
    x = torch.ones(n, device=device, requires_grad=True)
    res = torch.zeros(n, device=device)
    out = dropout_add(x, res, seed, rate)
    (dx,) = torch.autograd.grad(out.sum(), (x,))
    keep = keep_mask_flat(seed, n, rate, device=device)
    scale = torch.tensor(1.0 / (1.0 - rate)).item()
    assert torch.equal(out.detach() != 0, keep)          # forward vs plain
    assert torch.equal(dx != 0, keep)                    # backward vs plain
    assert (out.detach()[keep] == scale).all() and (dx[keep] == scale).all()
    share = float(keep.float().mean())
    sd = (rate * (1.0 - rate) / n) ** 0.5
    assert abs(share - (1.0 - rate)) < 5 * sd, share
    return share


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [RATE, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DROPOUT_SHAPES)
def test_fused_dropout_kernels_match_plain_version_bit_for_bit(
        cuda_device, shape, dtype, rate):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    res = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    g = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    x.requires_grad_(True)
    res.requires_grad_(True)
    before = (dropout_add.launches, dropout_add.bwd_launches)
    out = dropout_add(x, res, SEED, rate)
    dx, dres = torch.autograd.grad(out, (x, res), g)
    torch.cuda.synchronize()
    assert (dropout_add.launches, dropout_add.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = dropout_add_reference(x.detach(), res.detach(), SEED, rate)
    assert out.dtype == dtype and torch.equal(out, want)
    assert torch.equal(dx, dropout_scale_reference(g, SEED, rate))
    assert torch.equal(dres, g)
    scaled = dropout_scale(x.detach(), SEED + 1, rate)
    assert torch.equal(scaled,
                       dropout_scale_reference(x.detach(), SEED + 1, rate))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dropout_kernel_on_unaligned_views(cuda_device, dtype):
    """Views one element into their storage take the scalar path."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    base = torch.randn(2, 10_001, device=cuda_device, generator=gen).to(dtype)
    x, res = base[0, 1:], base[1, 1:]
    assert x.data_ptr() % 16 != 0
    got = dropout_add(x, res, SEED, RATE)
    torch.cuda.synchronize()
    assert torch.equal(got, dropout_add_reference(x, res, SEED, RATE))


@pytest.mark.gpu
def test_fused_dropout_kernels_draw_the_plain_versions_mask(cuda_device):
    check_fused_dropout_mask_identity(cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DROPOUT_SHAPES)
def test_fused_dropout_wide_design_equals_narrow_and_plain(cuda_device,
                                                           shape, dtype):
    """On aligned tensors #7 and #8 take "wide"; forced "narrow" on the same
    tensors, and the plain versions, give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, res = (torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
              for _ in range(2))
    for residual, counts, want in (
            (res, dropout_add.launches_by_design,
             dropout_add_reference(x, res, SEED, RATE)),
            (None, dropout_add.bwd_launches_by_design,
             dropout_scale_reference(x, SEED, RATE))):
        before = dict(counts)
        wide = dropout_ops._launch(x, residual, SEED, RATE)
        narrow = dropout_ops._launch(x, residual, SEED, RATE, "narrow")
        torch.cuda.synchronize()
        assert counts == {"scalar": before["scalar"],
                          "narrow": before["narrow"] + 1,
                          "wide": before["wide"] + 1}
        assert torch.equal(wide, want) and torch.equal(narrow, want)


@pytest.mark.gpu
@pytest.mark.parametrize("offset,design", [(4, "narrow"), (8, "wide")])
def test_fused_dropout_on_8_byte_aligned_views(cuda_device, offset, design):
    """bf16 views 8 bytes into a 16-byte row take "narrow" (and 16 bytes in,
    "wide"); both, and "scalar" forced on the same view, equal the plain
    versions bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    base = torch.randn(2, 40_016, device=cuda_device, generator=gen).to(
        torch.bfloat16)
    x, res = base[0, offset:offset + 40_003], base[1, offset:offset + 40_003]
    assert x.data_ptr() % 16 == 2 * offset % 16
    before = dict(dropout_add.launches_by_design)
    got = dropout_add(x, res, SEED, RATE)
    scalar = dropout_ops._launch(x, res, SEED, RATE, "scalar")
    scaled = dropout_scale(x, SEED, RATE)
    torch.cuda.synchronize()
    want = dropout_add_reference(x, res, SEED, RATE)
    assert torch.equal(got, want) and torch.equal(scalar, want)
    assert torch.equal(scaled, dropout_scale_reference(x, SEED, RATE))
    assert dropout_add.launches_by_design == {
        d: before[d] + (d == design) + (d == "scalar")
        for d in before}


# ---------------------------------------------------------------------------
# head-major single-tile attention (#3/#4)
# ---------------------------------------------------------------------------

# (B, H, Dh, Sq, Sk, lengths, causal): CASES (no row without a valid key;
# the CPU parity tests against the Pallas kernels use them), then a batch
# row with no valid key and causal Sq > Sk (rows above the diagonal), the
# `_small_fits` edge at Dh 64 and 128, and the flagship joint shape
SMALL_CASES = CASES
SMALL_GPU_CASES = CASES + [
    (2, 2, 32, 37, 10, (10, 0), True),
    (3, 5, 24, 77, 131, (131, 0, 60), False),
    (2, 16, 64, 512, 512, (512, 300), False),
    (2, 16, 128, 512, 512, (512, 300), True),
    (80, 12, 64, 164, 164, (164, 0) + (100,) * 78, False),
]


def bhsd_inputs(b, h, dh, sq, sk, lens, seed=0):
    """`packed_inputs` in the head-major layout: q (B, H, Sq, Dh), k/v
    (B, H, Sk, Dh), the key mask (B, Sk)."""
    q, k, v, mask = packed_inputs(b, h, dh, sq, sk, lens, seed)
    return tuple(np.ascontiguousarray(
        a.reshape(a.shape[0], a.shape[1], h, dh).transpose(0, 2, 1, 3))
        for a in (q, k, v)) + (mask,)


def small_attention_packed_view(q, k, v, kv_mask, n_heads, causal=False,
                                sm_scale=None, dropout_rate=0.0,
                                dropout_seed=None):
    """`small_attention` on the head-major views (B, H, S, Dh) of packed
    q, k, v (strided, the last dimension contiguous), its output back in
    the packed layout: the signature of `attention_packed`, for
    `check_mask_identity`."""
    b, sq, hd = q.shape

    def heads(t):
        return t.view(b, t.shape[1], n_heads, hd // n_heads).transpose(1, 2)

    out = small_attention(heads(q), heads(k), heads(v), kv_mask, causal,
                          sm_scale, dropout_rate, dropout_seed)
    return out.transpose(1, 2).reshape(b, sq, hd)


def _small_on(device, case, dtype, seed=0):
    b, h, dh, sq, sk, lens, _ = case
    q, k, v, mask = (torch.from_numpy(a).to(device)
                     for a in bhsd_inputs(b, h, dh, sq, sk, lens, seed))
    do = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        b, h, sq, dh).astype(np.float32)).to(device)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask, do.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SMALL_GPU_CASES)
def test_small_attention_kernels_match_plain_versions(cuda_device, case,
                                                      dtype, rate):
    q, k, v, mask, do = _small_on(cuda_device, case, dtype)
    causal = case[-1]
    seed = SEED if rate else None
    tol_f = TOL if dtype == torch.float32 else TOL_BF16
    tol_b = TOL_BWD if dtype == torch.float32 else TOL_BF16
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (small_attention.launches, small_attention.bwd_launches)
    by_design = dict(small_attention.bwd_launches_by_design)
    out = small_attention(q, k, v, mask, causal, None, rate, seed)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (small_attention.launches, small_attention.bwd_launches) == (
        before[0] + 1, before[1] + 2)
    _assert_rose(small_attention.bwd_launches_by_design, by_design,
                 flash_design(dtype, case[2]), 2)
    q, k, v = (t.detach() for t in (q, k, v))
    want = small_attention_reference(q, k, v, mask, causal, None, rate, seed)
    assert out.dtype == dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.detach(), want, **tol_f)
    wants = small_attention_bwd_reference(q, k, v, mask, do, causal, None,
                                          rate, seed)
    for g, w in zip(got, wants):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **tol_b)


def small_bwd_pair(q, k, v, mask, do, causal, rate, design):
    """`packed_bwd_pair` for the head-major backward (#4)."""
    seed = SEED if rate else None
    want = small_attention_bwd_reference(q, k, v, mask, do, causal, None,
                                         rate, seed)
    before = dict(small_attention.bwd_launches_by_design)
    if design is None:
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = small_attention(*leaves, mask, causal, None, rate, seed)
        got = torch.autograd.grad(out, leaves, do)
    else:
        got = attention_ops._launch_small_bwd(q, k, v, mask, do, causal,
                                              q.shape[-1] ** -0.5, rate,
                                              seed, design)
    torch.cuda.synchronize()
    _assert_rose(small_attention.bwd_launches_by_design, before,
                 design or flash_design(q.dtype, q.shape[-1]), 2)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("design", [None, "cuda_cores"])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", BWD_BF16_CASES)
def test_small_attention_bwd_kernel_bf16_in_both_designs(cuda_device, case,
                                                         rate, design):
    q, k, v, mask, do = _small_on(cuda_device, case, torch.bfloat16)
    got, want = small_bwd_pair(q, k, v, mask, do, case[-1], rate, design)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_small_attention_bwd_tensor_cores_are_deterministic(cuda_device,
                                                            rate):
    q, k, v, mask, do = _small_on(cuda_device, BWD_BF16_CASES[0],
                                  torch.bfloat16)
    first, _ = small_bwd_pair(q, k, v, mask, do, False, rate, None)
    second, _ = small_bwd_pair(q, k, v, mask, do, False, rate, None)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_attention_kernels_draw_the_plain_versions_mask(cuda_device,
                                                              dtype):
    before = (dict(small_attention.launches_by_design),
              dict(small_attention.bwd_launches_by_design))
    check_mask_identity(cuda_device, attn=small_attention_packed_view,
                        dtype=dtype)
    _assert_rose(small_attention.launches_by_design, before[0],
                 flash_design(dtype, 64), 2)
    _assert_rose(small_attention.bwd_launches_by_design, before[1],
                 flash_design(dtype, 64), 2)


# the packed and head-major forward in bf16, in both designs: the paths'
# shapes (serving B = 64 at S = 164, 116 and 100; training B = 80), each
# with a batch row that has no valid key, then the backward's odd cases
# (causal, Sq != Sk both ways, S = 512 at Dh 64 and 128, Dh 128 with a
# ragged tile) and Dh 48 (the tensor cores' general Dh <= 128 kernel)
FWD_BF16_CASES = [
    (64, 12, 64, s, s, (s, 0) + (s // 2,) * 62, False) for s in (164, 116,
                                                                 100)
] + BWD_BF16_CASES + [(3, 5, 48, 77, 131, (131, 0, 60), False)]


@functools.lru_cache(maxsize=1)
def _case_inputs(case):
    """`packed_inputs` of a case, kept for the next call: the forward tests
    walk each case's rates, designs and layouts in a row."""
    return packed_inputs(*case[:6])


def fwd_pair(layout, case, rate, design, device):
    """(kernel output, plain output) of #1 (``layout`` "packed") or #3
    ("small", on head-major copies of the same numbers) in bf16: through
    the public entry (the design the rule names, asserted) or, with
    ``design`` "cuda_cores", the private launcher forced to it."""
    b, h, dh, sq, sk, lens, causal = case
    seed = SEED if rate else None
    q, k, v, mask = _on(device, _case_inputs(case), torch.bfloat16)
    if layout == "packed":
        counts = attention_packed.launches_by_design
        want = attention_packed_reference(q, k, v, mask, h, causal, None,
                                          rate, seed)
        public = lambda: attention_packed(q, k, v, mask, h, causal, None,
                                          rate, seed)
        forced = lambda: attention_ops._launch_fwd(
            q, k, v, mask, h, causal, dh ** -0.5, rate, seed, design)
    else:
        q, k, v = (t.view(b, t.shape[1], h, dh).transpose(1, 2).contiguous()
                   for t in (q, k, v))
        counts = small_attention.launches_by_design
        want = small_attention_reference(q, k, v, mask, causal, None, rate,
                                         seed)
        public = lambda: small_attention(q, k, v, mask, causal, None, rate,
                                         seed)
        forced = lambda: attention_ops._launch_small_fwd(
            q, k, v, mask, causal, dh ** -0.5, rate, seed, design)
    before = dict(counts)
    got = public() if design is None else forced()
    torch.cuda.synchronize()
    _assert_rose(counts, before, design or flash_design(q.dtype, dh), 1)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "small"])
@pytest.mark.parametrize("design", [None, "cuda_cores"])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", FWD_BF16_CASES)
def test_attention_fwd_kernel_bf16_in_both_designs(cuda_device, case, rate,
                                                   design, layout):
    """#1 and #3 in bf16 through the design the rule names (the tensor
    cores at these shapes) and forced to CUDA cores, each against the
    plain forward."""
    got, want = fwd_pair(layout, case, rate, design, cuda_device)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "small"])
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_attention_fwd_tensor_cores_are_deterministic(cuda_device, rate,
                                                      layout):
    """Two tensor-core calls give bitwise the same output."""
    case = FWD_BF16_CASES[0]
    first, _ = fwd_pair(layout, case, rate, None, cuda_device)
    second, _ = fwd_pair(layout, case, rate, None, cuda_device)
    assert torch.equal(first, second)


# ---------------------------------------------------------------------------
# the decoder shapes of #1/#2, and the scores each pass computes
# ---------------------------------------------------------------------------

# (B, H, Dh, Sq, Sk, lengths, causal) at the flagship width: the caption and
# MT decoders' causal self-attention over T = 63 positions (the first
# 64-row tile ragged, the diagonal inside it) and their cross-attention
# over 100 regions and the 164-token joint [img; src] encoding; TIFG's
# causal image stream over 100 regions and its cross-attention over a
# 64-token caption; key masks with padded rows
DECODER_CASES = [
    (4, 12, 64, 63, 63, (63, 40, 63, 7), True),
    (4, 12, 64, 63, 100, (100, 71, 100, 9), False),
    (4, 12, 64, 63, 164, (164, 120, 164, 101), False),
    (4, 12, 64, 100, 100, (100, 55, 100, 1), True),
    (4, 12, 64, 100, 64, (64, 30, 64, 5), False),
]


def _padded_lengths(sk, b=24):
    """``b`` key lengths: full, a row with no valid key, then padded."""
    return (sk, 0) + tuple(sk - 1 - (5 * i) % sk for i in range(b - 2))


# the denoising objectives at their batch (B = 24 rows): MASS's decoder,
# causal over its 64-token span and across over the 128-token stream;
# BART's and AE's decoder, causal over 127 positions and across over the
# 128-token source; the stream encoder; the 127-token PC pair
DENOISING_CASES = [
    (24, 12, 64, sq, sk, _padded_lengths(sk), causal)
    for sq, sk, causal in ((64, 64, True), (64, 128, False),
                           (127, 127, True), (127, 128, False),
                           (128, 128, False), (127, 127, False))]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", DECODER_CASES + DENOISING_CASES)
def test_packed_attention_kernels_fp32_at_the_decoder_shapes(cuda_device,
                                                             case, rate):
    """#1 and #2 in fp32 (CUDA cores) against their plain versions."""
    q, k, v, mask, do = _grad_inputs(cuda_device, case, torch.float32)
    h, causal = case[1], case[-1]
    seed = SEED if rate else None
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    out = attention_packed(*leaves, mask, h, causal, None, rate, seed)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    _assert_rose(attention_packed.launches_by_design, before[0],
                 "cuda_cores", 1)
    _assert_rose(attention_packed.bwd_launches_by_design, before[1],
                 "cuda_cores", 2)
    want = attention_packed_reference(q, k, v, mask, h, causal, None, rate,
                                      seed)
    torch.testing.assert_close(out.detach(), want, **TOL)
    wants = attention_packed_bwd_reference(q, k, v, mask, do, h, causal, None,
                                           rate, seed)
    for g, w in zip(got, wants):
        torch.testing.assert_close(g, w, **TOL_BWD)


@pytest.mark.gpu
@pytest.mark.parametrize("design", [None, "cuda_cores"])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", DECODER_CASES + DENOISING_CASES)
def test_packed_attention_fwd_bf16_at_the_decoder_shapes(cuda_device, case,
                                                         rate, design):
    """#1 in bf16 through the design the rule names (the tensor cores) and
    forced to CUDA cores."""
    got, want = fwd_pair("packed", case, rate, design, cuda_device)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("design", [None, "cuda_cores"])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", DECODER_CASES + DENOISING_CASES)
def test_packed_attention_bwd_bf16_at_the_decoder_shapes(cuda_device, case,
                                                         rate, design):
    """#2 in bf16 through the design the rule names (the tensor cores) and
    forced to CUDA cores."""
    q, k, v, mask, do = _grad_inputs(cuda_device, case, torch.bfloat16)
    got, want = packed_bwd_pair(q, k, v, mask, do, case[1], case[-1], rate,
                                design)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **TOL_BF16)


@pytest.mark.gpu
def test_kernels_draw_the_plain_versions_mask_causal_at_t_63(cuda_device):
    """V = identity at the decoder's causal (63, 63) with 64-wide heads, in
    bf16 through the tensor cores in both directions."""
    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    check_mask_identity(cuda_device, s=63, dh=64, causal=True,
                        dtype=torch.bfloat16)
    _assert_rose(attention_packed.launches_by_design, before[0],
                 "tensor_cores", 2)
    _assert_rose(attention_packed.bwd_launches_by_design, before[1],
                 "tensor_cores", 2)


# The debug builds (-DM3P_SCORE_DUMP) of #2 and of #5/#6: their tensor-core
# kernels at Dh 64 without dropout also write the fp32 scores q.k they
# compute (and #2 its p) to a scratch; no model path loads these libraries
SCORE_DUMP = ("M3P_SCORE_DUMP",)
_SCORES_PACKED_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                           + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 14
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p])
_SCORES_FLASH_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                              + [ctypes.c_longlong] * 8
                              + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p])
_SCORES_FLASH_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                              + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 14
                              + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p])


def _strides(*tensors):
    return [st for t in tensors for st in t.stride()[:2]]


def _ulps(a, b):
    """Largest distance in fp32 units in the last place between two fp32
    tensors of one sign pattern (int32 views)."""
    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    return int((ia - ib).abs().max()) if ia.numel() else 0


def _score_report(what, a, b):
    return (f"{what}: {int((a != b).sum())} of {a.numel()} differ, max "
            f"|diff| {float((a - b).abs().max()):.3e}, {_ulps(a, b)} ulp")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [DECODER_CASES[0], DECODER_CASES[1]])
def test_packed_bwd_phases_see_bitwise_the_same_scores(cuda_device, case):
    """#2's phase 0 (s = q k^T, queries on the M side) and phase 1 (s^T =
    k q^T, keys on the M side) on the tensor cores: the same fp32 score at
    every (query, key) in range, and the same p wherever the pair is
    attended, bit for bit."""
    b, h, dh, sq, sk, _, causal = case
    q, k, v, mask, do = _grad_inputs(cuda_device, case, torch.bfloat16)
    fn = _build.bind("packed_attention_bwd", "m3p_packed_attention_bwd_scores",
                     _SCORES_PACKED_ARGTYPES, defines=SCORE_DUMP)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((b, h, sq, 3), dtype=torch.float32,
                        device=cuda_device)
    scores = torch.full((4, b, h, sq, sk), float("nan"), device=cuda_device)
    mask8 = mask.to(torch.bool).contiguous()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for phase in (0, 1):
        err = fn(phase, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask8.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, sq, sk, h,
                 dh, *_strides(q, k, v, do, dq, dk, dv), dh ** -0.5,
                 int(causal), scores.data_ptr(), stream)
        assert err == 0, err
    torch.cuda.synchronize()
    # the debug build computes what the shipped one does
    want = attention_packed_bwd_reference(q, k, v, mask, do, h, causal)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, **TOL_BF16)
    attended = mask[:, None, None, :].expand(b, h, sq, sk)
    if causal:
        tri = torch.ones(sq, sk, dtype=torch.bool,
                         device=cuda_device).tril(sk - sq)
        attended = attended & tri
    assert not scores[:2].isnan().any()
    s0, s1 = scores[0], scores[1]
    p0, p1 = scores[2][attended], scores[3][attended]
    assert not p0.isnan().any() and not p1.isnan().any()
    report = "; ".join([_score_report("scores", s0, s1),
                        _score_report("p", p0, p1)])
    print(report)
    assert torch.equal(s0, s1) and torch.equal(p0, p1), report


@pytest.mark.gpu
def test_flash_bwd_dkdv_pass_sees_bitwise_the_forwards_scores(cuda_device):
    """#6's dk/dv pass (s^T = k q^T over 128-key blocks) and #5 (s = q k^T
    over 128-query blocks) on the tensor cores, causal at S = 600 (ragged
    last tiles): the same fp32 score at every (query, key) in range, bit
    for bit."""
    case = (2, 4, 64, 600, 600, (600, 377), True)
    b, h, dh, sq, sk, _, causal = case
    q, k, v, mask, do = _grad_inputs(cuda_device, case, torch.bfloat16)
    mask8 = mask.to(torch.bool).contiguous()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    scores = torch.full((2, b, h, sq, sk), float("nan"), device=cuda_device)
    fwd = _build.bind("flash_attention", "m3p_flash_attention_fwd_scores",
                      _SCORES_FLASH_FWD_ARGTYPES, defines=SCORE_DUMP)
    o = torch.empty_like(q)
    stats = torch.empty((b, h, sq, 2), dtype=torch.float32,
                        device=cuda_device)
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask8.data_ptr(),
              o.data_ptr(), stats.data_ptr(), b, sq, sk, h, dh,
              *_strides(q, k, v, o), dh ** -0.5, int(causal),
              scores[0].data_ptr(), stream)
    assert err == 0, err
    bwd = _build.bind("flash_attention_bwd", "m3p_flash_attention_bwd_scores",
                      _SCORES_FLASH_BWD_ARGTYPES, defines=SCORE_DUMP)
    di = attention_ops.flash_row_dot(o, do, h).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for phase in (0, 1):
        err = bwd(phase, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask8.data_ptr(), do.data_ptr(), stats.data_ptr(),
                  di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, sq, sk, h, dh, *_strides(q, k, v, do, dq, dk, dv),
                  dh ** -0.5, int(causal), scores[1].data_ptr(), stream)
        assert err == 0, err
    torch.cuda.synchronize()
    torch.testing.assert_close(o, attention_flash_reference(
        q, k, v, mask, h, causal), **TOL_BF16)
    want = attention_flash_bwd_reference(q, k, v, mask, o, stats, do, h,
                                         causal)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, **TOL_BF16)
    assert not scores.isnan().any()
    report = _score_report("scores", scores[0], scores[1])
    print(report)
    assert torch.equal(scores[0], scores[1]), report


def test_score_dump_build_is_a_library_of_its_own(monkeypatch, tmp_path):
    """The debug build has its own library name and passes the macro to
    nvcc; the shipped build passes none."""
    commands = []

    def fake_nvcc(cmd, **kw):
        commands.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return types.SimpleNamespace(returncode=0, stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    shipped = _build.build("packed_attention_bwd")
    debug = _build.build("packed_attention_bwd", SCORE_DUMP)
    assert shipped != debug and shipped.exists() and debug.exists()
    assert "M3P_SCORE_DUMP" in debug.name
    assert [c for c in commands[0] if c.startswith("-D")] == []
    assert [c for c in commands[1] if c.startswith("-D")] == [
        "-DM3P_SCORE_DUMP"]
    assert _build.build("packed_attention_bwd", SCORE_DUMP) == debug
    assert len(commands) == 2       # built once


@pytest.mark.parametrize("source", ["packed_attention_bwd.cu",
                                    "packed_tile_bwd.cuh",
                                    "flash_attention.cu",
                                    "flash_attention_bwd.cu"])
def test_score_dump_code_is_behind_the_macro(source):
    """Every call of a kernel with the dump flag set, and every C entry of
    the debug build, lies inside ``#ifdef M3P_SCORE_DUMP``: the shipped
    libraries hold no instantiation that writes scores."""
    inside, depth = [], 0
    for line in (_build.CSRC / source).read_text().splitlines():
        if line.startswith("#ifdef M3P_SCORE_DUMP"):
            depth += 1
        elif line.startswith("#endif") and depth:
            depth -= 1
        inside.append(depth > 0)
    lines = (_build.CSRC / source).read_text().splitlines()
    flagged = [i for i, line in enumerate(lines)
               if re.search(r"true, true>|\bm3p_\w+_scores\(|\bdump_scores\(",
                            line)]
    assert flagged, source
    assert all(inside[i] for i in flagged), [lines[i] for i in flagged
                                             if not inside[i]]


# ---------------------------------------------------------------------------
# fused FFN + LayerNorm (#9)
# ---------------------------------------------------------------------------

# the kernel against its plain version: fp32 sums over D and H in another
# order (on the tensor cores too in bf16), erff and rsqrtf within 2 ulp; in
# bf16 each side rounds the hidden and the output once, so a value near a
# rounding boundary may land one bf16 ulp apart (1.6e-2 relative at
# |out| < 4)
TOL_FFN_FP32 = dict(rtol=1e-5, atol=1e-4)
FFN_MEAN_BF16 = 1e-3
FFN_SHAPES = [(d, h) for d in (64, 768) for h in (4 * d,)]
FFN_ROWS = [1, 70, 13120, 13121]


def ffn_inputs(device, m, d, h, dtype, seed=0):
    """x ~ N(0, 1), W ~ 0.02 N(0, 1) (the fused FFN tool's scale), nonzero
    biases and beta, gamma away from 1."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, device=device, generator=gen) * scale
                + shift).to(dtype)

    return (randn(m, d), randn(d, h, scale=0.02), randn(h, scale=0.1),
            randn(h, d, scale=0.02), randn(d, scale=0.1),
            randn(d, scale=0.1, shift=1.0), randn(d, scale=0.1))


def check_fused_ffn(got, want):
    """Max and mean |kernel - plain| after the tolerance of the dtype."""
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL_FFN_FP32)
    else:
        torch.testing.assert_close(got, want, **TOL_BF16)
        assert err.mean().item() <= FFN_MEAN_BF16, err.mean().item()
    return err.max().item(), err.mean().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", FFN_ROWS)
@pytest.mark.parametrize("d,h", FFN_SHAPES)
def test_fused_ffn_kernel_matches_plain_version(cuda_device, d, h, m, dtype):
    args = ffn_inputs(cuda_device, m, d, h, dtype)
    before = fused_ffn_ln.launches
    got = fused_ffn_ln(*args)
    torch.cuda.synchronize()
    assert fused_ffn_ln.launches == before + 1
    check_fused_ffn(got, reference_ffn_ln(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", [(1, 1), (200, 100), (1000, 70), (1024, 64),
                                 (192, 136)])
def test_fused_ffn_kernel_at_ragged_widths(cuda_device, d, h, dtype):
    """D not a multiple of 32 or of a slab, H not a multiple of a chunk,
    the largest D; in bf16 the CUDA-core kernel where D % 64 or H % 8 rule
    out the tensor-core one."""
    args = ffn_inputs(cuda_device, 45, d, h, dtype)
    check_fused_ffn(fused_ffn_ln(*args), reference_ffn_ln(*args))


@pytest.mark.gpu
def test_fused_ffn_kernel_on_an_unaligned_x(cuda_device):
    """x two bytes into its storage: bf16 takes the CUDA-core kernel."""
    args = list(ffn_inputs(cuda_device, 70, 64, 256, torch.bfloat16))
    x = torch.empty(70 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)
    x = x[1:].view(70, 64)
    x.copy_(args[0])
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    args[0] = x
    check_fused_ffn(fused_ffn_ln(*args), reference_ffn_ln(*args))


# the "cluster" design's edges: rows around its 64-row tile and past the
# tool's M, and its two narrowest widths
FFN_CLUSTER_CASES = ([(m, 768, 3072) for m in (1, 63, 64, 65, 13121)]
                     + [(65, d, 4 * d) for d in (128, 256)])


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,h", FFN_CLUSTER_CASES)
def test_fused_ffn_cluster_design_matches_plain_version(cuda_device, m, d,
                                                        h):
    """bf16 at D % 128 == 0 takes "cluster": within the tolerance of the
    plain version, two calls bitwise equal, and "tile32" forced on the same
    tensors within TOL_BF16 of it."""
    args = ffn_inputs(cuda_device, m, d, h, torch.bfloat16, seed=m)
    before = dict(fused_ffn_ln.launches_by_design)
    got = fused_ffn_ln(*args)
    again = fused_ffn_ln(*args)
    tile32 = fused_ffn_ops._launch(*args, 1e-12, _design="tile32")
    torch.cuda.synchronize()
    assert fused_ffn_ln.launches_by_design == {
        "cuda_cores": before["cuda_cores"], "tile32": before["tile32"] + 1,
        "cluster": before["cluster"] + 2}
    check_fused_ffn(got, reference_ffn_ln(*args))
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tile32, **TOL_BF16)


# ---------------------------------------------------------------------------
# a failing launch raises (runs without a card)
# ---------------------------------------------------------------------------


def _failing_launch(monkeypatch):
    """Every C entry point returns CUDA error 700; no stream is needed."""
    monkeypatch.setattr(_build, "bind", lambda *a: lambda *args: 700)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))


def _launch_small(which):
    """fp32 (CUDA cores), or bf16 on the tensor cores for "fwd_tc" and
    "bwd_tc"."""
    dtype = torch.bfloat16 if which.endswith("_tc") else torch.float32
    q, k, v, mask, do = _small_on("cpu", CASES[0], dtype)
    if which.startswith("fwd"):
        return attention_ops._launch_small_fwd(q, k, v, mask, False, 0.25,
                                               RATE, SEED)
    return attention_ops._launch_small_bwd(q, k, v, mask, do, False, 0.25,
                                           RATE, SEED)


def _launch_packed(which):
    dtype = torch.bfloat16 if which.endswith("_tc") else torch.float32
    q, k, v, mask, do = _grad_inputs("cpu", CASES[0], dtype)
    if which.startswith("fwd"):
        return attention_ops._launch_fwd(q, k, v, mask, 3, False, 0.25, RATE,
                                         SEED)
    return attention_ops._launch_bwd(q, k, v, mask, do, 3, False, 0.25, RATE,
                                     SEED)


def _launch_flash(which):
    """A bf16 case the tensor-core design takes."""
    q, k, v, mask, do = _grad_inputs("cpu", FLASH_CASES[0], torch.bfloat16)
    if which == "fwd":
        return attention_ops._launch_flash_fwd(q, k, v, mask, 2, False, 0.25,
                                               RATE, SEED)
    stats = torch.zeros(2, 2, 200, 2)
    return attention_ops._launch_flash_bwd(q, k, v, mask, q, stats, do, 2,
                                           False, 0.25, RATE, SEED)


def _all_launch_counts():
    return (small_attention.launches, small_attention.bwd_launches,
            fused_ffn_ln.launches, dict(fused_ffn_ln.launches_by_design),
            dropout_add.launches, dropout_add.bwd_launches,
            dict(dropout_add.launches_by_design),
            dict(dropout_add.bwd_launches_by_design),
            attention_flash.launches,
            attention_flash.bwd_launches, _design_launches(),
            attention_packed.launches, attention_packed.bwd_launches,
            dict(attention_packed.launches_by_design),
            dict(attention_packed.bwd_launches_by_design),
            dict(small_attention.launches_by_design),
            dict(small_attention.bwd_launches_by_design))


@pytest.mark.parametrize("which", ["small_fwd", "small_bwd", "small_bwd_tc",
                                   "packed_bwd", "packed_bwd_tc",
                                   "fused_ffn", "flash_fwd", "flash_bwd",
                                   "packed_fwd", "packed_fwd_tc",
                                   "small_fwd_tc", "fused_ffn_tile32",
                                   "fused_ffn_cluster", "dropout_wide",
                                   "dropout_narrow", "dropout_scalar",
                                   "dropout_scale_wide"])
def test_a_failing_launch_raises_and_counts_nothing(monkeypatch, which):
    _failing_launch(monkeypatch)
    before = _all_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 700"):
        if which == "fused_ffn":
            fused_ffn_ops._launch(*ffn_inputs("cpu", 5, 8, 16,
                                              torch.float32), 1e-12)
        elif which.startswith("fused_ffn"):    # bf16 at D 64 or 128
            d = 64 if which.endswith("tile32") else 128
            args = ffn_inputs("cpu", 5, d, 4 * d, torch.bfloat16)
            assert fused_ffn_ops._ffn_design(
                args[0], args[1], args[3], args[0]) == which[10:]
            fused_ffn_ops._launch(*args, 1e-12)
        elif which.startswith("dropout"):
            x, res = _dropout_view(torch.bfloat16, which.split("_")[-1])
            dropout_ops._launch(x, None if "scale" in which else res, SEED,
                                RATE)
        elif which.startswith("flash"):
            _launch_flash(which[6:])
        elif which.startswith("packed"):
            _launch_packed(which[7:])
        else:
            _launch_small(which[6:])
    assert _all_launch_counts() == before


# ---------------------------------------------------------------------------
# the design rule of the packed and head-major forward and backward (runs
# without a card)
# ---------------------------------------------------------------------------


def _rule_tensors(layout, dtype=torch.bfloat16, dh=64, n_heads=2, b=2,
                  s=24):
    """q, k, v in one of the layouts the rule tells apart, packed
    (B, S, H*Dh), on the CPU (whose allocator aligns to 64 bytes)."""
    hd = n_heads * dh
    if layout == "misaligned_slice":     # starts one element (2 bytes) in
        q = torch.randn(b, s, hd + 8, dtype=dtype)[..., 1:hd + 1]
    elif layout == "row_stride_not_8":   # rows of hd + 4 elements
        q = torch.randn(b, s, hd + 4, dtype=dtype)[..., :hd]
    elif layout == "batch_stride_not_8":
        q = torch.randn(b * s * hd + 4, dtype=dtype).as_strided(
            (b, s, hd), (s * hd + 4, hd, 1))
    elif layout == "longer_than_max_seq":
        q = torch.randn(b, attention_ops.MAX_SEQ + 1, hd, dtype=dtype)
    else:                                # contiguous
        q = torch.randn(b, s, hd, dtype=dtype)
    return q, torch.randn(b, s, hd, dtype=dtype), torch.randn(b, s, hd,
                                                              dtype=dtype)


def _head_major(t, n_heads):
    """The (B, H, S, Dh) view of a packed tensor (strides kept)."""
    return t.unflatten(2, (n_heads, -1)).transpose(1, 2)


RULE_CASES = [
    (torch.float32, 64, "contiguous", "cuda_cores"),
    (torch.bfloat16, 16, "contiguous", "tensor_cores"),
    (torch.bfloat16, 24, "contiguous", "cuda_cores"),
    (torch.bfloat16, 64, "contiguous", "tensor_cores"),
    (torch.bfloat16, 128, "contiguous", "tensor_cores"),
    (torch.bfloat16, 144, "contiguous", "cuda_cores"),
    (torch.bfloat16, 64, "misaligned_slice", "cuda_cores"),
    (torch.bfloat16, 64, "row_stride_not_8", "cuda_cores"),
    (torch.bfloat16, 64, "batch_stride_not_8", "cuda_cores"),
    (torch.bfloat16, 64, "longer_than_max_seq", "cuda_cores"),
]


@pytest.mark.parametrize("dtype,dh,layout,want", RULE_CASES)
def test_packed_bwd_design_follows_the_kernel_rule(dtype, dh, layout, want):
    """`_packed_design`: the tensor cores take bf16 with Dh a multiple of
    16 up to 128, S <= MAX_SEQ, 16-byte aligned data and batch and row
    strides that are multiples of 8 elements (the C entry's rule); any
    tensor of the call can send it to CUDA cores."""
    q, k, v = _rule_tensors(layout, dtype, dh)
    assert attention_ops._packed_design(2, q, k, v) == want
    assert attention_ops._packed_design(2, q.contiguous(), k, v, q) == want
    if want == "tensor_cores":
        odd = _rule_tensors("row_stride_not_8", dtype, dh)[0]
        assert attention_ops._packed_design(2, q, k, v, odd) == "cuda_cores"


@pytest.mark.parametrize("dtype,dh,layout,want", RULE_CASES + [
    (torch.bfloat16, 64, "head_stride_not_8", "cuda_cores")])
def test_small_bwd_design_follows_the_kernel_rule(dtype, dh, layout, want):
    """`_small_design`: the same rule on (B, H, S, Dh) tensors, with the
    head stride a multiple of 8 elements too; the head-major views of
    packed tensors (head stride Dh) qualify."""
    if layout == "head_stride_not_8":    # heads of S * Dh + 4 elements
        q, k, v = _head_stride_not_8(dtype, dh)
    else:
        q, k, v = (_head_major(t, 2) for t in _rule_tensors(layout, dtype,
                                                             dh))
    assert attention_ops._small_design(q, k, v) == want
    assert attention_ops._small_design(q.contiguous(), k, v, q) == want


def _head_stride_not_8(dtype, dh):
    """Head-major q whose heads lie S * Dh + 4 elements apart, k and v
    contiguous."""
    b, h, s = 2, 2, 24
    q = torch.randn(b * h * (s * dh + 4), dtype=dtype).as_strided(
        (b, h, s, dh), (h * (s * dh + 4), s * dh + 4, dh, 1))
    return q, torch.randn(b, h, s, dh, dtype=dtype), torch.randn(
        b, h, s, dh, dtype=dtype)


@pytest.mark.parametrize("dtype,dh,layout,want", RULE_CASES)
def test_packed_fwd_design_follows_the_kernel_rule(monkeypatch, dtype, dh,
                                                   layout, want):
    """`_launch_fwd` hands the C entry the design `_packed_design` names
    for q, k, v and its output (the backward's rule) and counts it."""
    calls = _recording_entry(monkeypatch)
    q, k, v = _rule_tensors(layout, dtype, dh)
    before = dict(attention_packed.launches_by_design)
    attention_ops._launch_fwd(q, k, v, None, 2, False, 0.125, 0.0, None)
    assert [c[1] for c in calls] == [attention_ops._DESIGNS.index(want)]
    _assert_rose(attention_packed.launches_by_design, before, want, 1)


@pytest.mark.parametrize("dtype,dh,layout,want", RULE_CASES + [
    (torch.bfloat16, 64, "head_stride_not_8", "cuda_cores")])
def test_small_fwd_design_follows_the_kernel_rule(monkeypatch, dtype, dh,
                                                  layout, want):
    """`_launch_small_fwd` the same on (B, H, S, Dh) tensors, the head
    stride a multiple of 8 elements too."""
    calls = _recording_entry(monkeypatch)
    if layout == "head_stride_not_8":
        q, k, v = _head_stride_not_8(dtype, dh)
    else:
        q, k, v = (_head_major(t, 2) for t in _rule_tensors(layout, dtype,
                                                             dh))
    before = dict(small_attention.launches_by_design)
    attention_ops._launch_small_fwd(q, k, v, None, False, 0.125, 0.0, None)
    assert [c[1] for c in calls] == [attention_ops._DESIGNS.index(want)]
    _assert_rose(small_attention.launches_by_design, before, want, 1)


def _keep_counts(monkeypatch):
    """Give every kernel counter a copy for this test, restored after it,
    so that launches through a stub C entry leave no count behind for
    tests that read the counters later in the same process."""
    for fn in (attention_packed, attention_flash, small_attention,
               dropout_add, fused_ffn_ln):
        for name in ("launches", "bwd_launches", "launches_by_design",
                     "bwd_launches_by_design"):
            if hasattr(fn, name):
                value = getattr(fn, name)
                monkeypatch.setattr(fn, name, dict(value)
                                    if isinstance(value, dict) else value)


def _recording_entry(monkeypatch):
    """A stub C entry that records (dtype, design, phase, bits pointer)
    and succeeds."""
    calls = []

    def entry(*args):
        calls.append((args[0], args[1], args[2], args[12]))
        return 0

    monkeypatch.setattr(_build, "bind", lambda *a: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    _keep_counts(monkeypatch)
    return calls


def _bwd_call(layout, dtype, rate, design):
    """One private backward launch (two kernel launches) of a case both
    designs take in bf16; returns the by-design counts it moves."""
    seed = SEED if rate else None
    if layout == "packed":
        q, k, v, mask, do = _grad_inputs("cpu", CASES[0], dtype)
        attention_ops._launch_bwd(q, k, v, mask, do, 3, False, 0.25, rate,
                                  seed, design)
        return attention_packed.bwd_launches_by_design
    q, k, v, mask, do = _small_on("cpu", CASES[0], dtype)
    attention_ops._launch_small_bwd(q, k, v, mask, do, False, 0.25, rate,
                                    seed, design)
    return small_attention.bwd_launches_by_design


@pytest.mark.parametrize("layout", ["packed", "small"])
@pytest.mark.parametrize("dtype,forced,code,rate", [
    (torch.bfloat16, None, 1, 0.0), (torch.bfloat16, None, 1, RATE),
    (torch.bfloat16, "cuda_cores", 0, RATE), (torch.float32, None, 0, RATE)])
def test_bwd_launches_pass_the_design_and_count_it(monkeypatch, layout,
                                                   dtype, forced, code,
                                                   rate):
    """Each launch hands the C entry the design's code (0 CUDA cores, 1
    tensor cores), phase 0 then 1, and a keep-word scratch only with
    dropout on the tensor cores; each adds one to that design's count.
    ``_design`` (the private argument the timing uses) names the CUDA-core
    design."""
    calls = _recording_entry(monkeypatch)
    design = attention_ops._DESIGNS[code]
    counts = (attention_packed.bwd_launches_by_design if layout == "packed"
              else small_attention.bwd_launches_by_design)
    before = dict(counts)
    _bwd_call(layout, dtype, rate, forced)
    dtype_code = 1 if dtype == torch.bfloat16 else 0
    assert [c[:3] for c in calls] == [(dtype_code, code, 0),
                                      (dtype_code, code, 1)]
    with_bits = design == "tensor_cores" and rate > 0
    assert all((c[3] is not None) == with_bits for c in calls)
    assert counts == {d: before[d] + (2 if d == design else 0)
                      for d in before}


@pytest.mark.parametrize("layout", ["packed", "small"])
@pytest.mark.parametrize("dtype,forced,code,rate", [
    (torch.bfloat16, None, 1, 0.0), (torch.bfloat16, None, 1, RATE),
    (torch.bfloat16, "cuda_cores", 0, RATE), (torch.float32, None, 0, RATE)])
def test_fwd_launches_pass_the_design_and_count_it(monkeypatch, layout,
                                                   dtype, forced, code,
                                                   rate):
    """Each forward launch hands the C entry the dtype and the design's
    code (0 CUDA cores, 1 tensor cores) and adds one to that design's
    count; ``_design`` names the CUDA-core design."""
    calls = _recording_entry(monkeypatch)
    seed = SEED if rate else None
    if layout == "packed":
        q, k, v, mask = _on("cpu", packed_inputs(*CASES[0][:6]), dtype)
        counts = attention_packed.launches_by_design
        before = dict(counts)
        attention_ops._launch_fwd(q, k, v, mask, 3, False, 0.25, rate, seed,
                                  forced)
    else:
        q, k, v, mask, _ = _small_on("cpu", CASES[0], dtype)
        counts = small_attention.launches_by_design
        before = dict(counts)
        attention_ops._launch_small_fwd(q, k, v, mask, False, 0.25, rate,
                                        seed, forced)
    dtype_code = 1 if dtype == torch.bfloat16 else 0
    assert [c[:2] for c in calls] == [(dtype_code, code)]
    _assert_rose(counts, before, attention_ops._DESIGNS[code], 1)


@pytest.mark.parametrize("layout", ["packed", "small", "packed_fwd",
                                    "small_fwd"])
@pytest.mark.parametrize("why", ["float32", "misaligned", "too_long"])
def test_forced_tensor_cores_outside_the_rule_raise(monkeypatch, layout,
                                                    why):
    """A forced ``_design="tensor_cores"`` on tensors the rule sends to CUDA
    cores raises before any launch, backward or forward, and does not run
    the CUDA-core design instead."""
    calls = _recording_entry(monkeypatch)
    if why == "float32":
        q, k, v = _rule_tensors("contiguous", torch.float32)
    elif why == "misaligned":
        q, k, v = _rule_tensors("misaligned_slice")
    else:
        q, k, v = _rule_tensors("longer_than_max_seq")
        k = v = torch.randn(q.shape, dtype=q.dtype)
    do = torch.randn(q.shape, dtype=q.dtype)
    before = _all_launch_counts()
    with pytest.raises(ValueError, match="does not take these tensors"):
        if layout == "packed":
            attention_ops._launch_bwd(q, k, v, None, do, 2, False, 0.125,
                                      0.0, None, "tensor_cores")
        elif layout == "packed_fwd":
            attention_ops._launch_fwd(q, k, v, None, 2, False, 0.125, 0.0,
                                      None, "tensor_cores")
        elif layout == "small_fwd":
            attention_ops._launch_small_fwd(
                *(_head_major(t, 2) for t in (q, k, v)), None, False, 0.125,
                0.0, None, "tensor_cores")
        else:
            attention_ops._launch_small_bwd(
                *(_head_major(t, 2) for t in (q, k, v)), None,
                _head_major(do, 2), False, 0.125, 0.0, None, "tensor_cores")
    assert calls == [] and _all_launch_counts() == before


# ---------------------------------------------------------------------------
# the design rules of the fused FFN and the fused dropout (run without a
# card)
# ---------------------------------------------------------------------------


def _offset(t, elems):
    """A copy of ``t`` whose data starts ``elems`` elements into a
    64-byte-aligned allocation (the CPU allocator aligns to 64)."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype)
    view = flat[elems:].view(t.shape)
    view.copy_(t)
    return view


# (dtype, D, H, tensor shifted by 2 bytes, design): D % 128, D above
# CLUSTER_MAX_D, H % 64 and every tensor's alignment can each send bf16
# from "cluster" to "tile32" or further
FFN_RULE_CASES = [
    (torch.bfloat16, 768, 3072, None, "cluster"),
    (torch.bfloat16, 128, 512, None, "cluster"),
    (torch.float32, 768, 3072, None, "cuda_cores"),
    (torch.bfloat16, 192, 768, None, "tile32"),      # D % 128 != 0
    (torch.bfloat16, 896, 3584, None, "tile32"),     # D > CLUSTER_MAX_D
    (torch.bfloat16, 768, 3064, None, "tile32"),     # H % 64 != 0
    (torch.bfloat16, 768, 3068, None, "cuda_cores"), # H % 8 != 0
    (torch.bfloat16, 200, 800, None, "cuda_cores"),  # D % 64 != 0
    (torch.bfloat16, 128, 512, "x", "cuda_cores"),
    (torch.bfloat16, 128, 512, "w1", "cuda_cores"),
    (torch.bfloat16, 128, 512, "w2", "cuda_cores"),
]


@pytest.mark.parametrize("dtype,d,h,shifted,want", FFN_RULE_CASES)
def test_ffn_design_follows_the_kernel_rule(monkeypatch, dtype, d, h,
                                            shifted, want):
    """`_launch` hands the C entry the design `_ffn_design` names (codes 0
    CUDA cores, 1 "tile32", 2 "cluster") and counts it."""
    calls = _recording_entry(monkeypatch)
    x, w1, b1, w2, b2, gamma, beta = ffn_inputs("cpu", 3, d, h, dtype)
    if shifted == "x":
        x = _offset(x, 1)
    elif shifted == "w1":
        w1 = _offset(w1, 1)
    elif shifted == "w2":
        w2 = _offset(w2, 1)
    before = dict(fused_ffn_ln.launches_by_design)
    fused_ffn_ops._launch(x, w1, b1, w2, b2, gamma, beta, 1e-12)
    assert [c[:2] for c in calls] == [
        (1 if dtype == torch.bfloat16 else 0,
         fused_ffn_ops._DESIGNS.index(want))]
    _assert_rose(fused_ffn_ln.launches_by_design, before, want, 1)


@pytest.mark.parametrize("shift,want", [(0, "cluster"), (2, "tile32"),
                                        (1, "cuda_cores")])
def test_ffn_design_follows_the_output_alignment(shift, want):
    """The output must be 16-byte aligned for "cluster" and 4-byte aligned
    for "tile32" (it is allocated fresh on the model path)."""
    x, w1, _, w2, *_ = ffn_inputs("cpu", 3, 128, 512, torch.bfloat16)
    out = _offset(x, shift)
    assert fused_ffn_ops._ffn_design(x, w1, w2, out) == want


@pytest.mark.parametrize("d,h,forced", [
    (192, 768, "cluster"), (768, 3064, "cluster"), (200, 800, "tile32"),
    (768, 3072, "fp32_cluster"), (768, 3072, "fp32_tile32"),
    (128, 512, "unknown")])
def test_forced_ffn_design_outside_the_rule_raises(monkeypatch, d, h,
                                                   forced):
    """A forced ``_design`` whose rule these tensors break raises before any
    launch and counts nothing."""
    calls = _recording_entry(monkeypatch)
    dtype = torch.float32 if forced.startswith("fp32") else torch.bfloat16
    args = ffn_inputs("cpu", 3, d, h, dtype)
    before = _all_launch_counts()
    with pytest.raises(ValueError, match="does not take these tensors"):
        fused_ffn_ops._launch(*args, 1e-12,
                              _design=forced.replace("fp32_", ""))
    assert calls == [] and _all_launch_counts() == before


def test_forced_ffn_designs_inside_the_rule_launch_them(monkeypatch):
    """On tensors "cluster" takes, ``_design`` "tile32" and "cuda_cores"
    launch those designs (the timing in turns)."""
    calls = _recording_entry(monkeypatch)
    args = ffn_inputs("cpu", 3, 128, 512, torch.bfloat16)
    before = dict(fused_ffn_ln.launches_by_design)
    for forced in (None, "tile32", "cuda_cores"):
        fused_ffn_ops._launch(*args, 1e-12, _design=forced)
    assert [c[1] for c in calls] == [2, 1, 0]
    assert fused_ffn_ln.launches_by_design == {
        d: before[d] + 1 for d in before}


def _dropout_view(dtype, design, n=1003):
    """x and a residual of ``n`` elements whose data lie where
    `_dropout_design` names ``design``: 16-byte aligned ("wide"), 8 bytes in
    (bf16 "narrow"), one element in ("scalar")."""
    elems = {"wide": 0, "narrow": 4, "scalar": 1}[design]
    return (_offset(torch.randn(n).to(dtype), elems),
            _offset(torch.randn(n).to(dtype), elems))


def _recording_dropout_entry(monkeypatch):
    """A stub C entry of the fused dropout recording (dtype, width code) and
    succeeding."""
    calls = []

    def entry(*args):
        # add: (dtype, x, res, out, n, ...); scale: (dtype, x, out, n, ...)
        calls.append((args[0], args[-2]))
        return 0

    monkeypatch.setattr(_build, "bind", lambda *a: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    _keep_counts(monkeypatch)
    return calls


@pytest.mark.parametrize("dtype,layout,want", [
    (torch.bfloat16, "wide", "wide"), (torch.bfloat16, "narrow", "narrow"),
    (torch.bfloat16, "scalar", "scalar"), (torch.float32, "wide", "wide"),
    (torch.float32, "scalar", "scalar")])
@pytest.mark.parametrize("residual", [True, False])
def test_dropout_width_follows_the_alignment(monkeypatch, dtype, layout,
                                             want, residual):
    """`_launch` hands the C entry the width code of the design the
    pointers allow (2 "wide": all 16-byte aligned, 1 "narrow": all aligned
    to 4 elements, 0 "scalar") and counts it under #7 or #8."""
    calls = _recording_dropout_entry(monkeypatch)
    x, res = _dropout_view(dtype, layout)
    counts = (dropout_add.launches_by_design if residual
              else dropout_add.bwd_launches_by_design)
    before = dict(counts)
    dropout_ops._launch(x, res if residual else None, SEED, RATE)
    assert calls == [(dropout_ops._KERNEL_DTYPES[dtype],
                      dropout_ops._DESIGNS.index(want))]
    _assert_rose(counts, before, want, 1)


def test_dropout_width_follows_the_residual_too(monkeypatch):
    """An aligned x with a residual 8 bytes in takes "narrow"."""
    calls = _recording_dropout_entry(monkeypatch)
    x, _ = _dropout_view(torch.bfloat16, "wide")
    _, res = _dropout_view(torch.bfloat16, "narrow")
    dropout_ops._launch(x, res, SEED, RATE)
    assert calls == [(1, 1)]


@pytest.mark.parametrize("layout,forced", [
    ("narrow", "wide"), ("scalar", "narrow"), ("scalar", "wide"),
    ("wide", "unknown")])
def test_forced_dropout_design_outside_the_rule_raises(monkeypatch, layout,
                                                       forced):
    """A forced ``_design`` wider than the pointers allow raises before any
    launch and counts nothing."""
    calls = _recording_dropout_entry(monkeypatch)
    x, res = _dropout_view(torch.bfloat16, layout)
    before = _all_launch_counts()
    with pytest.raises(ValueError, match="does not take these tensors"):
        dropout_ops._launch(x, res, SEED, RATE, forced)
    assert calls == [] and _all_launch_counts() == before


def test_forced_narrow_dropout_on_aligned_tensors_launches_it(monkeypatch):
    """The timing in turns: "narrow" and "scalar" forced on tensors "wide"
    takes pass their width codes."""
    calls = _recording_dropout_entry(monkeypatch)
    x, res = _dropout_view(torch.bfloat16, "wide")
    for forced in (None, "narrow", "scalar"):
        dropout_ops._launch(x, res, SEED, RATE, forced)
    assert [c[1] for c in calls] == [2, 1, 0]


# ---------------------------------------------------------------------------
# the frozen-weight int8 GEMMs (ops/quant.py): cuBLASLt's torch._int_mm on
# the card against the same call on the CPU, bit for bit (integer
# accumulation; the quantization and the scaling are elementwise IEEE fp32)
# ---------------------------------------------------------------------------

INT8_ROWS = (1, 5, 17, 2048, 2049)
# the flagship's tied vocab table, padded to a multiple of 8 rows
HEAD_WORDS, HEAD_DIM = 250002, 768


@functools.lru_cache(maxsize=None)
def _int8_head_table():
    gen = torch.Generator().manual_seed(7)
    weight = torch.randn(HEAD_WORDS, HEAD_DIM, generator=gen) * 0.05
    return quant_ops.Q8Table(weight, torch.bfloat16, -(-HEAD_WORDS // 8) * 8)


def _int8_input(m, k, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(m, k, generator=gen) * 3).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", INT8_ROWS)
@pytest.mark.parametrize("n,k", [(3072, 768), (768, 3072), (2304, 768)])
def test_int8_gemm_on_the_card_equals_the_cpu(cuda_device, m, n, k, dtype):
    """`int8_matmul_pre` through a `Q8Table` (the FFN's and the fused
    QKV's shapes) at 1-2049 rows: the card's output equals the CPU's bit
    for bit; fewer than 17 rows take the padded route."""
    weight = _int8_input(n, k, torch.float32, 1) * 0.05
    table = quant_ops.Q8Table(weight, dtype)
    x = _int8_input(m, k, dtype, 2)
    want = table(x)
    before = dict(quant_ops.int8_matmul_pre.calls_by_route)
    got = table.to(cuda_device)(x.to(cuda_device))
    torch.cuda.synchronize()
    route = "int8_row_pad" if m < quant_ops.CUDA_MIN_ROWS else "int8"
    assert quant_ops.int8_matmul_pre.calls_by_route[route] == before[route] + 1
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", INT8_ROWS)
def test_int8_vocab_head_on_the_card_equals_the_cpu(cuda_device, m):
    """`int8_matmul_nt_pre` over the (250,008, 768) padded head table in
    bf16: card and CPU bit for bit."""
    table = _int8_head_table()
    x = _int8_input(m, HEAD_DIM, torch.bfloat16, 3)
    want = quant_ops.int8_matmul_nt_pre(x, table.wq, table.sw.t())
    got = quant_ops.int8_matmul_nt_pre(x.to(cuda_device),
                                       table.wq.to(cuda_device),
                                       table.sw.t().to(cuda_device))
    torch.cuda.synchronize()
    assert got.shape == (m, table.wq.shape[0])
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_int8_gemm_refuses_k_or_n_off_the_rule_on_the_card(cuda_device):
    """The CUDA GEMM takes K and N that are multiples of 8: another shape
    raises and never falls back to a float GEMM."""
    x = torch.randn(32, 20, device=cuda_device)
    table = quant_ops.Q8Table(torch.randn(24, 20), torch.float32).to(
        cuda_device)
    before = quant_ops.int8_matmul_pre.calls
    with pytest.raises(ValueError, match="multiples of 8"):
        table(x)
    assert quant_ops.int8_matmul_pre.calls == before


# ---------------------------------------------------------------------------
# the dynamic int8 training GEMMs (ops/quant.py): forward and backward on
# the card against the CPU at the shapes where the CUDA rule bites -- the
# MCT step's FFN (13120 tokens), 16 rows, a token count that is not a
# multiple of 8 (a wgrad's contraction), the tied 250,002-word head (the
# head's dgrad contracts over V)
# ---------------------------------------------------------------------------

# (function, M, K, N): x (M, K); w (K, N), or (N, K) for the nt head
INT8_TRAIN_CASES = [
    ("int8_matmul_qbwd", 13120, 768, 3072),
    ("int8_matmul_qbwd", 13120, 3072, 768),
    ("int8_matmul_qbwd", 16, 768, 3072),
    ("int8_matmul_qbwd", 1001, 768, 2304),
    ("int8_matmul_nt", 37, HEAD_DIM, HEAD_WORDS),
    ("int8_matmul_nt", 320, HEAD_DIM, HEAD_WORDS),
    ("int8_matmul", 1001, 768, 3072),
    ("int8_matmul", 16, 768, HEAD_WORDS),
]


def _train_gemm_pair(name, m, k, n, dtype, device):
    """(output, dx, dw, routes) of one call with its backward on
    ``device``, from the same seeded inputs."""
    fn = getattr(quant_ops, name)
    x = _int8_input(m, k, dtype, 11).to(device).requires_grad_()
    w_shape = (n, k) if name == "int8_matmul_nt" else (k, n)
    w = (_int8_input(*w_shape, dtype, 12) * 0.05).to(device)
    w.requires_grad_()
    g = _int8_input(m, n, dtype, 13).to(device)
    quant_ops.zero_counts()
    out = fn(x, w)
    out.backward(g)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (out.detach().cpu(), x.grad.cpu(), w.grad.cpu(),
            dict(fn.calls_by_route), dict(fn.calls_by_pass))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16])
@pytest.mark.parametrize("case", INT8_TRAIN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_int8_training_gemm_on_the_card_equals_the_cpu(cuda_device, case,
                                                       dtype):
    """The forward and the int8 dgrad / wgrad bit for bit with the CPU;
    the straight-through backward of `int8_matmul` (bf16 operands summed
    in fp32 in another order, then rounded to bf16) within one bf16
    rounding.  Every GEMM takes the card's int8 route, padded where the
    rule needs it, and none falls back to a float GEMM."""
    name, m, k, n = case
    got = _train_gemm_pair(name, m, k, n, dtype, cuda_device)
    want = _train_gemm_pair(name, m, k, n, dtype, torch.device("cpu"))
    assert got[0].dtype == dtype and torch.equal(got[0], want[0])
    if name == "int8_matmul":
        for a, b in zip(got[1:3], want[1:3]):
            torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2,
                                       atol=1e-2)
    else:
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    routes, passes = got[3], got[4]
    n_gemms = 1 if name == "int8_matmul" else 3
    assert passes == {"fwd": 1, "bwd": n_gemms - 1}
    assert routes["cpu"] == 0 and routes["int8"] + routes["int8_pad"] == \
        n_gemms
    # rows below 17, or a width or (in an int8 wgrad) a token count off
    # the multiple of 8
    odd = m < 17 or n % 8 or (m % 8 and name != "int8_matmul")
    assert (routes["int8_pad"] > 0) == bool(odd)
