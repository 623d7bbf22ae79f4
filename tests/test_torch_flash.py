"""The port's flash attention (m3p_tpu_torch.ops.attention) against the JAX
package: the plain forward and backward against the Pallas flash kernels in
interpret mode (several blocks, causal, the decode offset) and against
mha_reference and its vjp, the backward with dropout against autograd
through the plain forward, the dropout mask identity (V = identity), the
wrapper on CPU tensors, which kernel the model's attention takes at each
length, and which design of the flash kernels a call takes.  The CUDA kernels against the plain versions are in
test_torch_kernels.py."""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.ops.attention import flash_attention as jax_flash_attention
from m3p_tpu.ops.attention import flash_attention_bwd as jax_flash_bwd
from m3p_tpu.ops.attention import mha_reference as jax_mha_reference
from m3p_tpu_torch.model.layers import MultiHeadAttention
from m3p_tpu_torch.ops import attention as ops
from m3p_tpu_torch.ops.attention import (
    attention, attention_flash, attention_flash_bwd_reference,
    attention_flash_reference, attention_packed_reference)
from test_torch_kernels import FLASH_CASES, RATE, SEED, TOL, TOL_BWD
from test_torch_kernels import check_mask_identity, output_grad
from test_torch_kernels import packed_inputs as _inputs

torch.set_num_threads(1)

# cases the interpret-mode Pallas kernels share semantics on: every row has
# a valid key; blocks of 64 queries and 128 keys give several of each
JAX_CASES = [
    (2, 2, 16, 200, 200, (200, 71), False),
    (2, 2, 16, 200, 200, (200, 71), True),
    (2, 2, 16, 70, 300, (300, 129), True),
    (2, 2, 16, 100, 128, (128, 50), False),
]
BLOCKS = dict(block_q=64, block_k=128)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _split(x, h):
    b, s, hd = x.shape
    return jnp.asarray(x.reshape(b, s, h, hd // h).transpose(0, 2, 1, 3))


def _merge(x):
    x = np.asarray(x)
    b, h, s, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, s, h * d)


def _plain_grads(q, k, v, mask, do, h, causal):
    tq, tk, tv, tm, tdo = _torch(q, k, v, mask, do)
    out, stats = attention_flash_reference(tq, tk, tv, tm, h, causal,
                                           return_stats=True)
    return attention_flash_bwd_reference(tq, tk, tv, tm, out, stats, tdo, h,
                                         causal)


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", JAX_CASES)
def test_flash_reference_matches_jax_interpret_kernel(b, h, dh, sq, sk, lens,
                                                      causal):
    q, k, v, mask = _inputs(b, h, dh, sq, sk, lens)
    want = jax_flash_attention(_split(q, h), _split(k, h), _split(v, h),
                               jnp.asarray(mask), causal=causal,
                               interpret=True, **BLOCKS)
    got = attention_flash_reference(*_torch(q, k, v, mask), h, causal)
    np.testing.assert_allclose(got.numpy(), _merge(want), **TOL)


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", JAX_CASES)
def test_flash_bwd_reference_matches_jax_interpret_kernel(b, h, dh, sq, sk,
                                                          lens, causal):
    q, k, v, mask = _inputs(b, h, dh, sq, sk, lens)
    do = output_grad(b, h, dh, sq)
    jq, jk, jv, jdo = (_split(x, h) for x in (q, k, v, do))
    out, l_res, m_res = jax_flash_attention(
        jq, jk, jv, jnp.asarray(mask), causal=causal, interpret=True,
        return_residuals=True, **BLOCKS)
    want = jax_flash_bwd(jq, jk, jv, jnp.asarray(mask), out, l_res, m_res,
                         jdo, causal=causal, interpret=True, **BLOCKS)
    got = _plain_grads(q, k, v, mask, do, h, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _merge(w), **TOL_BWD)


def test_flash_reference_rows_without_a_key_against_interpret_kernel():
    """Causal with Sq > Sk: the first Sq - Sk rows attend to no key.  The
    port gives them the mean of v over Sk, as mha_reference does; the
    Pallas kernel skips every key block of those rows' query block and
    returns 0 there (ROADMAP section 3).  The other rows agree."""
    b, h, dh, sq, sk = 2, 2, 16, 200, 128
    q, k, v, mask = _inputs(b, h, dh, sq, sk, (128, 50))
    want = _merge(jax_flash_attention(
        _split(q, h), _split(k, h), _split(v, h), jnp.asarray(mask),
        causal=True, interpret=True, **BLOCKS))
    got = attention_flash_reference(*_torch(q, k, v, mask), h,
                                    True).numpy()
    empty = sq - sk
    np.testing.assert_allclose(got[:, empty:], want[:, empty:], **TOL)
    assert not want[:, :64].any()
    for row in range(b):
        mean = v[row].mean(0)
        np.testing.assert_allclose(got[row, :empty],
                                   np.broadcast_to(mean, (empty, h * dh)),
                                   **TOL)


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", FLASH_CASES)
def test_flash_reference_and_backward_match_mha_reference(b, h, dh, sq, sk,
                                                          lens, causal):
    """Forward and backward against mha_reference and its vjp, rows
    without a valid key included (uniform over Sk; no gradient through a
    masked score)."""
    q, k, v, mask = _inputs(b, h, dh, sq, sk, lens)
    do = output_grad(b, h, dh, sq)
    fn = lambda a, b_, c: jax_mha_reference(  # noqa: E731
        a, b_, c, jnp.asarray(mask), causal=causal)
    want, vjp = jax.vjp(fn, _split(q, h), _split(k, h), _split(v, h))
    got = attention_flash_reference(*_torch(q, k, v, mask), h, causal)
    np.testing.assert_allclose(got.numpy(), _merge(want), **TOL)
    grads = _plain_grads(q, k, v, mask, do, h, causal)
    for g, w in zip(grads, vjp(_split(do, h))):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), _merge(w), **TOL_BWD)


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", FLASH_CASES[:4])
def test_flash_bwd_reference_with_dropout_matches_autograd(b, h, dh, sq, sk,
                                                           lens, causal):
    """The plain backward at rate 0.1 is the gradient of the plain forward
    with the same seed, and the wrapper's forward and backward are the
    plain ones on CPU tensors."""
    q, k, v, mask = _torch(*_inputs(b, h, dh, sq, sk, lens))
    do = torch.from_numpy(output_grad(b, h, dh, sq))
    for t in (q, k, v):
        t.requires_grad_(True)
    out, stats = attention_flash_reference(q, k, v, mask, h, causal, None,
                                           RATE, SEED, return_stats=True)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = attention_flash_bwd_reference(q.detach(), k.detach(), v.detach(),
                                        mask, out.detach(), stats, do, h,
                                        causal, None, RATE, SEED)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL_BWD)
    wrapped = attention_flash(q, k, v, mask, h, causal, None, RATE, SEED)
    assert torch.equal(wrapped, out)
    for g, w in zip(torch.autograd.grad(wrapped, (q, k, v), do), got):
        assert torch.equal(g, w)


def test_flash_mask_does_not_depend_on_the_row_chunk(monkeypatch):
    """The keep mask is a function of the global (row, col): chunks of 16
    rows give the output of chunks of 512, and up to 512 tokens it is the
    packed kernels' mask."""
    q, k, v, mask = _torch(*_inputs(2, 2, 16, 70, 300, (300, 129)))
    whole = attention_flash_reference(q, k, v, mask, 2, True, None, RATE,
                                      SEED)
    monkeypatch.setattr(ops, "FLASH_ROW_CHUNK", 16)
    chunked = attention_flash_reference(q, k, v, mask, 2, True, None, RATE,
                                        SEED)
    assert torch.equal(chunked, whole)
    packed = attention_packed_reference(q, k, v, mask, 2, True, None, RATE,
                                        SEED)
    torch.testing.assert_close(whole, packed, **TOL)
    assert not torch.equal(whole, attention_flash_reference(q, k, v, mask, 2,
                                                            True))


def test_flash_dropout_mask_identity_of_the_plain_versions():
    share = check_mask_identity("cpu", attn=attention_flash, s=96)
    assert 0.7 < share < 0.8


def test_flash_wrapper_takes_plain_version_on_cpu_and_refuses_the_rest():
    q, k, v, mask = _torch(*_inputs(2, 2, 16, 70, 300, (300, 129)))
    before = (attention_flash.launches, attention_flash.bwd_launches)
    for t in (q, k, v):
        t.requires_grad_(True)
    got = attention_flash(q, k, v, mask, 2, causal=True)
    got.sum().backward()
    assert (attention_flash.launches, attention_flash.bwd_launches) == before
    assert torch.equal(got, attention_flash_reference(q, k, v, mask, 2,
                                                      True))
    with pytest.raises(ValueError, match="dropout_seed"):
        attention_flash(q, k, v, mask, 2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        attention_flash_reference(q, k, v, mask, 2, dropout_rate=0.1)
    meta = [t.detach().to("meta") for t in (q, k, v, mask)]
    with pytest.raises(ValueError):
        attention_flash(*meta, 2)


def _spy(monkeypatch):
    calls = []
    for name in ("attention_packed", "attention_flash"):
        real = getattr(ops, name)

        def record(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, record)
    return calls


@pytest.mark.parametrize("sq,sk,route", [
    (512, 512, "attention_packed"), (513, 513, "attention_flash"),
    (512, 513, "attention_flash"), (513, 512, "attention_flash"),
    (1, 512, "attention_packed")])
def test_attention_dispatches_by_length_as_the_jax_module(monkeypatch, sq,
                                                          sk, route):
    """Packed kernels when Sq and Sk are at most 512, flash above
    (`m3p_tpu/model/layers.py:267-270`)."""
    calls = _spy(monkeypatch)
    q, k, v, mask = _torch(*_inputs(1, 2, 8, sq, sk, (sk,)))
    out = attention(q, k, v, mask, 2)
    assert calls == [route] and out.shape == q.shape


@pytest.mark.parametrize("s,route", [(512, "attention_packed"),
                                     (513, "attention_flash")])
def test_multi_head_attention_takes_the_kernel_of_its_length(monkeypatch, s,
                                                             route):
    calls = _spy(monkeypatch)
    mha = MultiHeadAttention(2, 16)
    x = torch.randn(1, s, 16)
    out = mha(x, torch.ones(1, s, dtype=torch.bool))
    assert calls == [route] and out.shape == x.shape


def _design_layout(dtype, dh, layout, n_heads=2, b=2, s=24):
    """(n_heads, q, k, v) in one of the layouts the design rule tells
    apart, on the CPU (whose allocator aligns to 64 bytes)."""
    hd = n_heads * dh
    if layout == "xmlm_projection":
        # the model's q_lin/k_lin/v_lin outputs: (B, S, 768), 12 heads of 64
        x = torch.randn(b, s, 768, dtype=dtype)
        w = torch.randn(768, 768, dtype=dtype)
        return (12, *(torch.nn.functional.linear(x, w) for _ in range(3)))
    if layout == "contiguous":
        return (n_heads, *(torch.randn(b, s, hd, dtype=dtype)
                           for _ in range(3)))
    if layout == "misaligned_slice":     # starts one element (2 bytes) in
        big = torch.randn(b, s, hd + 8, dtype=dtype)
        q = big[..., 1:hd + 1]
    elif layout == "row_stride_not_8":   # rows of hd + 4 elements
        q = torch.randn(b, s, hd + 4, dtype=dtype)[..., :hd]
    else:                                # batch_stride_not_8
        q = torch.randn(b * s * hd + 4, dtype=dtype).as_strided(
            (b, s, hd), (s * hd + 4, hd, 1))
    return (n_heads, q, torch.randn(b, s, hd, dtype=dtype),
            torch.randn(b, s, hd, dtype=dtype))


@pytest.mark.parametrize("dtype,dh,layout,want", [
    (torch.float32, 64, "contiguous", "cuda_cores"),
    (torch.bfloat16, 16, "contiguous", "tensor_cores"),
    (torch.bfloat16, 24, "contiguous", "cuda_cores"),
    (torch.bfloat16, 64, "contiguous", "tensor_cores"),
    (torch.bfloat16, 128, "contiguous", "tensor_cores"),
    (torch.bfloat16, 144, "contiguous", "cuda_cores"),
    (torch.bfloat16, 64, "misaligned_slice", "cuda_cores"),
    (torch.bfloat16, 64, "row_stride_not_8", "cuda_cores"),
    (torch.bfloat16, 64, "batch_stride_not_8", "cuda_cores"),
    (torch.bfloat16, 64, "xmlm_projection", "tensor_cores"),
    (torch.float32, 64, "xmlm_projection", "cuda_cores"),
])
def test_flash_design_follows_the_kernel_rule(dtype, dh, layout, want):
    """`_flash_design`: the tensor cores take bf16 with Dh a multiple of 16
    up to 128, 16-byte aligned data and batch and row strides that are
    multiples of 8 elements (`tc_fits` in csrc/flash_tile.cuh); any tensor
    of the call can send it to CUDA cores."""
    n_heads, q, k, v = _design_layout(dtype, dh, layout)
    assert ops._flash_design(n_heads, q, k, v) == want
    # the rule looks at every tensor, not only q
    assert ops._flash_design(n_heads, q.contiguous(), k, v, q) == want
    if want == "tensor_cores":
        odd = _design_layout(dtype, dh, "row_stride_not_8", n_heads)[1]
        assert ops._flash_design(n_heads, q, k, v, odd) == "cuda_cores"


@pytest.mark.parametrize("dtype,forced,code", [
    (torch.bfloat16, None, 1), (torch.bfloat16, "cuda_cores", 0),
    (torch.float32, None, 0)])
def test_flash_launches_pass_the_design_and_count_it(monkeypatch, dtype,
                                                     forced, code):
    """Each launch hands the C entry the design's code (0 CUDA cores, 1
    tensor cores) and adds one to that design's count; ``_design`` (the
    private argument the timing uses) names the CUDA-core design."""
    calls = []

    def entry(*args):
        calls.append(args[:3])
        return 0

    monkeypatch.setattr(ops._build, "bind", lambda *a: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    q, k, v, mask = (torch.from_numpy(a) for a in
                     _inputs(2, 2, 64, 70, 130, (130, 40)))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    design = ops._DESIGNS[code]
    before = (dict(attention_flash.launches_by_design),
              dict(attention_flash.bwd_launches_by_design))
    out, stats = ops._launch_flash_fwd(q, k, v, mask, 2, False, 0.125, 0.0,
                                       None, forced)
    ops._launch_flash_bwd(q, k, v, mask, out, stats, q, 2, False, 0.125,
                          0.0, None, forced)
    dtype_code = 1 if dtype == torch.bfloat16 else 0
    assert calls == [(dtype_code, code, q.data_ptr()),
                     (dtype_code, code, 0), (dtype_code, code, 1)]
    for counts, old, n in zip((attention_flash.launches_by_design,
                               attention_flash.bwd_launches_by_design),
                              before, (1, 2)):
        assert counts == {d: old[d] + (n if d == design else 0)
                          for d in old}
