"""The port's head-major single-tile attention (small_attention, #3/#4, and
the entry attention_bhsd of m3p_tpu_torch.ops.attention) on the CPU, where
the plain versions run, against the JAX package: the plain forward against
the Pallas `small_attention` in interpret mode and the plain backward
against the vjp of `_attention_pallas_small` (rate 0: the TPU's hardware
PRNG has no interpret mode), with the JAX suite's tolerances
(`tests/test_ops.py:150-186`: 2e-5 forward, 5e-5 gradients, fp32); at rate
0.1 the backward against autograd through the plain forward, the mask
identity (V = identity), the packed path on the same tensors, and the
dispatch of attention_bhsd.  Rows without a valid key follow mha_reference
(the Pallas kernel averages over its 128-lane padded key length there), so
the comparisons with the kernel have none but one, which pins that
difference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.ops.attention import _attention_pallas_small
from m3p_tpu.ops.attention import mha_reference as jax_mha_reference
from m3p_tpu.ops.attention import small_attention as jax_small_attention
from m3p_tpu_torch.ops import attention as ops
from m3p_tpu_torch.ops.attention import (
    attention_bhsd, attention_packed, mha_reference, small_attention,
    small_attention_bwd, small_attention_bwd_reference,
    small_attention_reference)
from test_torch_kernels import (
    RATE, SEED, SMALL_CASES, TOL, TOL_BWD, bhsd_inputs, check_mask_identity,
    small_attention_packed_view)

torch.set_num_threads(1)

TOL_JAX_FWD = dict(rtol=0, atol=2e-5)
TOL_JAX_BWD = dict(rtol=0, atol=5e-5)


def _grad_of_output(case, seed=1):
    b, h, dh, sq = case[:4]
    return np.random.RandomState(seed).randn(b, h, sq, dh).astype(np.float32)


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", SMALL_CASES)
def test_plain_forward_matches_the_pallas_kernel(b, h, dh, sq, sk, lens,
                                                 causal):
    q, k, v, mask = bhsd_inputs(b, h, dh, sq, sk, lens)
    want = jax_small_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(mask),
                               causal=causal, interpret=True)
    got = small_attention_reference(*map(torch.from_numpy, (q, k, v, mask)),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_JAX_FWD)


@pytest.mark.parametrize("case", SMALL_CASES)
def test_plain_backward_matches_the_pallas_vjp(case):
    b, h, dh, sq, sk, lens, causal = case
    q, k, v, mask = bhsd_inputs(b, h, dh, sq, sk, lens)
    g = _grad_of_output(case)
    scale = 1.0 / dh ** 0.5
    jmask = jnp.asarray(mask)

    def fwd(q_, k_, v_):
        return _attention_pallas_small(q_, k_, v_, jmask, None, causal,
                                       scale, 0.0, True)

    _, vjp = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = small_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, mask, g)), causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL_JAX_BWD,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_a_row_without_a_valid_key_follows_mha_reference(causal):
    """Forward: the mean of v over Sk (JAX `mha_reference`); backward: no
    gradient through the masked scores (the vjp of `mha_reference`)."""
    b, h, dh, sq, sk = 2, 3, 16, 12, 9
    q, k, v, mask = bhsd_inputs(b, h, dh, sq, sk, (9, 0), seed=4)
    g = _grad_of_output((b, h, dh, sq), seed=5)
    jq, jk, jv, jm, jg = map(jnp.asarray, (q, k, v, mask, g))
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_mha_reference(
        q_, k_, v_, jm, causal=causal), jq, jk, jv)
    got = small_attention_reference(*map(torch.from_numpy, (q, k, v, mask)),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_JAX_FWD)
    grads = small_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, mask, g)), causal=causal)
    for a, w in zip(grads, vjp(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL_JAX_BWD)


def test_a_row_without_a_valid_key_differs_from_the_pallas_kernel():
    """The recorded difference (ROADMAP section 3, fault 3): the Pallas
    kernel pads Sk to 128 lanes and averages v over all of them, and its
    backward lets dq through the masked scores; the port averages over Sk
    and gives no gradient there.  Rows with a valid key agree."""
    b, h, dh, s = 2, 2, 16, 40
    q, k, v, mask = bhsd_inputs(b, h, dh, s, s, (s, 0), seed=6)
    g = _grad_of_output((b, h, dh, s), seed=7)
    jq, jk, jv, jm, jg = map(jnp.asarray, (q, k, v, mask, g))
    want = np.asarray(jax_small_attention(jq, jk, jv, jm, interpret=True))
    _, vjp = jax.vjp(lambda q_, k_, v_: _attention_pallas_small(
        q_, k_, v_, jm, None, False, 0.25, 0.0, True), jq, jk, jv)
    jdq = np.asarray(vjp(jg)[0])
    got = small_attention_reference(*map(torch.from_numpy, (q, k, v, mask)))
    dq = small_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, mask, g)))[0]
    np.testing.assert_allclose(
        want[1], np.broadcast_to(v[1].sum(1, keepdims=True) / 128,
                                 want[1].shape), **TOL_JAX_FWD)
    np.testing.assert_allclose(
        got[1].numpy(), np.broadcast_to(v[1].mean(1, keepdims=True),
                                        want[1].shape), **TOL_JAX_FWD)
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL_JAX_FWD)
    assert np.abs(jdq[1]).max() > 0.1 and float(dq[1].abs().max()) == 0.0
    np.testing.assert_allclose(dq[0].numpy(), jdq[0], **TOL_JAX_BWD)


@pytest.mark.parametrize("case", SMALL_CASES[:3])
def test_backward_with_dropout_is_the_gradient_of_the_plain_forward(case):
    """At rate 0.1 the plain backward equals autograd through the plain
    forward (the same Philox mask, the scale inside p), and the wrapper's
    backward is the plain backward."""
    b, h, dh, sq, sk, lens, causal = case
    q, k, v, mask = map(torch.from_numpy, bhsd_inputs(b, h, dh, sq, sk,
                                                      lens))
    g = torch.from_numpy(_grad_of_output(case))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = small_attention_reference(q, k, v, mask, causal, None, RATE, SEED)
    auto = torch.autograd.grad(out, (q, k, v), g)
    args = [t.detach() for t in (q, k, v)]
    plain = small_attention_bwd_reference(*args, mask, g, causal, None, RATE,
                                          SEED)
    for a, w in zip(plain, auto):
        torch.testing.assert_close(a, w, **TOL_BWD)
    wrapped = small_attention(q, k, v, mask, causal, None, RATE, SEED)
    assert torch.equal(wrapped, out)
    for a, w in zip(torch.autograd.grad(wrapped, (q, k, v), g), plain):
        assert torch.equal(a, w)
    # dropout is on
    assert not torch.equal(out, small_attention_reference(*args, mask,
                                                          causal))


def test_dropout_mask_identity_of_the_plain_versions():
    share = check_mask_identity("cpu", attn=small_attention_packed_view)
    assert 0.7 < share < 0.8


@pytest.mark.parametrize("case", SMALL_CASES[1:4])
def test_the_head_major_entry_agrees_with_the_packed_path(case):
    """attention_bhsd with dropout on (B, H, S, Dh) tensors and
    attention_packed on their packed copies draw one mask; they differ only
    in where the 1/(1 - rate) scale is rounded.  Gradients too."""
    b, h, dh, sq, sk, lens, causal = case
    q, k, v, mask = map(torch.from_numpy, bhsd_inputs(b, h, dh, sq, sk,
                                                      lens))
    g = torch.from_numpy(_grad_of_output(case))

    def packed(t):
        return t.transpose(1, 2).reshape(b, t.shape[2], h * dh)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention_bhsd(*leaves, mask, causal, None, RATE, SEED)
    grads = torch.autograd.grad(out, leaves, g)
    pleaves = [packed(t).requires_grad_(True) for t in (q, k, v)]
    pout = attention_packed(*pleaves, mask, h, causal, None, RATE, SEED)
    pgrads = torch.autograd.grad(pout, pleaves, packed(g))
    torch.testing.assert_close(packed(out.detach()), pout.detach(), **TOL)
    for a, w in zip(grads, pgrads):
        torch.testing.assert_close(packed(a), w, **TOL_BWD)


def _spy(monkeypatch):
    calls = []
    for name in ("small_attention", "attention_flash", "mha_reference"):
        real = getattr(ops, name)

        def record(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, record)
    return calls


@pytest.mark.parametrize("sq,sk,rate,route", [
    (512, 512, RATE, "small_attention"), (1, 512, RATE, "small_attention"),
    (513, 40, RATE, "attention_flash"), (40, 513, RATE, "attention_flash"),
    (40, 512, 0.0, "attention_flash"), (600, 511, 0.0, "mha_reference"),
    (40, 37, 0.0, "mha_reference")])
def test_the_head_major_entry_dispatches_as_the_jax_entry(monkeypatch, sq,
                                                          sk, rate, route):
    """`m3p_tpu/ops/attention.py:966-988`: with dropout, the single-tile
    kernels when Sq, Sk <= 512, else flash; at rate 0, flash from Sk = 512,
    else mha_reference."""
    calls = _spy(monkeypatch)
    q, k, v, mask = map(torch.from_numpy, bhsd_inputs(1, 2, 8, sq, sk,
                                                      (sk,)))
    seed = SEED if rate else None
    out = attention_bhsd(q, k, v, mask, False, None, rate, seed)
    assert calls == [route] and out.shape == q.shape
    if route == "attention_flash" and rate == 0.0:
        torch.testing.assert_close(out, mha_reference(q, k, v, mask), **TOL)


def test_the_wrappers_take_the_plain_versions_on_the_cpu_only():
    q, k, v, mask = map(torch.from_numpy, bhsd_inputs(*SMALL_CASES[2][:6]))
    do = torch.ones_like(q)
    before = (small_attention.launches, small_attention.bwd_launches)
    got = small_attention(q, k, v, mask, True)
    assert torch.equal(got, small_attention_reference(q, k, v, mask, True))
    grads = small_attention_bwd(q, k, v, mask, do, True)
    for a, w in zip(grads, small_attention_bwd_reference(q, k, v, mask, do,
                                                         True)):
        assert torch.equal(a, w)
    assert (small_attention.launches, small_attention.bwd_launches) == before
    for fn in (small_attention, attention_bhsd, small_attention_reference):
        with pytest.raises(ValueError, match="dropout_seed"):
            fn(q, k, v, mask, False, None, RATE)
    meta = [t.to("meta") for t in (q, k, v, mask)]
    with pytest.raises(ValueError, match="no kernel for device"):
        small_attention(*meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        small_attention_bwd(*meta, meta[0])
