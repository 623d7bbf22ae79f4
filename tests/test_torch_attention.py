"""The port's packed attention (m3p_tpu_torch.ops.attention) against the
JAX package: the plain forward and backward against the Pallas kernels run
in interpret mode and against mha_reference and its vjp, the backward with
dropout against autograd through the plain forward, the dropout mask
identity (V = identity), and the dispatching wrapper on CPU tensors.  The
CUDA kernels against the plain versions are in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.ops.attention import attention_packed as jax_attention_packed
from m3p_tpu.ops.attention import mha_reference as jax_mha_reference
from m3p_tpu.ops.attention import small_attention_packed_bwd
from m3p_tpu_torch.ops.attention import (
    attention_packed, attention_packed_bwd_reference,
    attention_packed_reference, mha_reference)
from test_torch_kernels import CASES, RATE, SEED, TOL, TOL_BWD
from test_torch_kernels import check_mask_identity, output_grad
from test_torch_kernels import packed_inputs as _inputs

torch.set_num_threads(1)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", CASES)
def test_packed_reference_matches_jax_interpret_kernel(b, h, dh, sq, sk,
                                                       lens, causal):
    q, k, v, mask = _inputs(b, h, dh, sq, sk, lens)
    want = jax_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        None, h, causal, None, 0.0, True)
    got = attention_packed_reference(*_torch(q, k, v, mask), h,
                                     causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_reference_fully_masked_row_matches_interpret_kernel():
    """A batch row with no valid key (the engine's padding rows): the mean
    of v.  Sk = 128 fills the Pallas kernel's lane padding exactly, so its
    uniform row spans the same keys."""
    q, k, v, mask = _inputs(2, 3, 16, 128, 128, (128, 0), seed=1)
    want = jax_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        None, 3, False, None, 0.0, True)
    got = attention_packed_reference(*_torch(q, k, v, mask), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(0), got[1].shape),
                               **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_packed_reference_fully_masked_row_matches_mha_reference(causal):
    b, h, dh, sq, sk = 2, 3, 16, 7, 37
    q, k, v, mask = _inputs(b, h, dh, sq, sk, (37, 0), seed=2)

    def split(x):
        return x.reshape(b, -1, h, dh).transpose(0, 2, 1, 3)

    want = jax_mha_reference(jnp.asarray(split(q)), jnp.asarray(split(k)),
                             jnp.asarray(split(v)), jnp.asarray(mask),
                             causal=causal)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, sq, h * dh)
    got = attention_packed_reference(*_torch(q, k, v, mask), h,
                                     causal=causal)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(causal):
    rng = np.random.RandomState(3)
    q = rng.randn(2, 3, 9, 16).astype(np.float32)
    k = rng.randn(2, 3, 13, 16).astype(np.float32)
    v = rng.randn(2, 3, 13, 16).astype(np.float32)
    mask = np.arange(13)[None, :] < np.array([[13], [4]])
    want = jax_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), causal=causal)
    got = mha_reference(*_torch(q, k, v, mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v, mask = _inputs(2, 3, 16, 10, 37, (37, 20))
    before = attention_packed.launches
    got = attention_packed(*_torch(q, k, v, mask), 3, causal=True)
    want = attention_packed_reference(*_torch(q, k, v, mask), 3, causal=True)
    assert attention_packed.launches == before
    assert torch.equal(got, want)


def test_wrapper_refuses_dropout_and_unknown_devices():
    """Dropout runs on the CPU through the plain version, but not without a
    seed (the JAX entry's rule); a device without a kernel raises."""
    q, k, v, mask = _torch(*_inputs(1, 2, 8, 4, 4, (4,)))
    got = attention_packed(q, k, v, mask, 2, dropout_rate=0.5,
                           dropout_seed=3)
    want = attention_packed_reference(q, k, v, mask, 2, dropout_rate=0.5,
                                      dropout_seed=3)
    assert torch.equal(got, want)
    assert not torch.equal(got, attention_packed(q, k, v, mask, 2))
    with pytest.raises(ValueError, match="dropout_seed"):
        attention_packed(q, k, v, mask, 2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        attention_packed_bwd_reference(q, k, v, mask, q, 2,
                                       dropout_rate=0.1)
    meta = [t.to("meta") for t in (q, k, v, mask)]
    with pytest.raises(ValueError):
        attention_packed(*meta, 2)


def _split(x, h):
    b, s, hd = x.shape
    return jnp.asarray(x.reshape(b, s, h, hd // h).transpose(0, 2, 1, 3))


def _merge(x):
    x = np.asarray(x)
    b, h, s, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, s, h * d)


def _mha_vjp(q, k, v, mask, do, h, causal):
    """dq, dk, dv of jax.vjp(mha_reference) in the packed layout."""
    _, vjp = jax.vjp(lambda a, b_, c: jax_mha_reference(
        a, b_, c, jnp.asarray(mask), causal=causal),
        _split(q, h), _split(k, h), _split(v, h))
    return [_merge(g) for g in vjp(_split(do, h))]


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", CASES)
def test_packed_bwd_reference_matches_jax_interpret_kernel(b, h, dh, sq, sk,
                                                           lens, causal):
    q, k, v, mask = _inputs(b, h, dh, sq, sk, lens)
    do = output_grad(b, h, dh, sq)
    want = small_attention_packed_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(do), n_heads=h, causal=causal, interpret=True)
    got = attention_packed_bwd_reference(*_torch(q, k, v, mask, do)[:4],
                                         torch.from_numpy(do), h,
                                         causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_BWD)


def test_packed_bwd_reference_fully_masked_row_against_interpret_kernel():
    """Sk = 128 fills the Pallas kernel's lane padding, so its uniform row
    spans the same keys: dv agrees everywhere and dq/dk on the batch row
    with keys.  On the row without any, the port gives dq = dk = 0, as the
    vjp of mha_reference does; the Pallas kernel lets a gradient through the
    masked scores there (ROADMAP section 3)."""
    b, h, dh, s = 2, 3, 16, 128
    q, k, v, mask = _inputs(b, h, dh, s, s, (128, 0), seed=1)
    do = output_grad(b, h, dh, s)
    want = small_attention_packed_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(do), n_heads=h, interpret=True)
    dq, dk, dv = attention_packed_bwd_reference(
        *_torch(q, k, v, mask), torch.from_numpy(do), h)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want[2]), **TOL_BWD)
    for g, w in zip((dq, dk), want[:2]):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w)[0],
                                   **TOL_BWD)
        assert not g[1].any() and np.abs(np.asarray(w)[1]).max() > 1e-2
    vjp = _mha_vjp(q, k, v, mask, do, h, False)
    for g, w in zip((dq, dk, dv), vjp):
        np.testing.assert_allclose(g.numpy(), w, **TOL_BWD)


@pytest.mark.parametrize("causal", [False, True])
def test_packed_bwd_reference_fully_masked_row_matches_mha_vjp(causal):
    b, h, dh, sq, sk = 2, 3, 16, 7, 37
    q, k, v, mask = _inputs(b, h, dh, sq, sk, (37, 0), seed=2)
    do = output_grad(b, h, dh, sq)
    got = attention_packed_bwd_reference(*_torch(q, k, v, mask),
                                         torch.from_numpy(do), h,
                                         causal=causal)
    for g, w in zip(got, _mha_vjp(q, k, v, mask, do, h, causal)):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, **TOL_BWD)


@pytest.mark.parametrize("b,h,dh,sq,sk,lens,causal", CASES)
def test_packed_bwd_reference_with_dropout_matches_autograd(b, h, dh, sq, sk,
                                                            lens, causal):
    """The plain backward at rate 0.1 is the gradient of the plain forward
    at rate 0.1 with the same seed; the wrapper's backward is the plain
    one."""
    q, k, v, mask = _torch(*_inputs(b, h, dh, sq, sk, lens))
    do = torch.from_numpy(output_grad(b, h, dh, sq))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = attention_packed_reference(q, k, v, mask, h, causal=causal,
                                     dropout_rate=RATE, dropout_seed=SEED)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = attention_packed_bwd_reference(
        q.detach(), k.detach(), v.detach(), mask, do, h, causal=causal,
        dropout_rate=RATE, dropout_seed=SEED)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL_BWD)
    wrapped = attention_packed(q, k, v, mask, h, causal=causal,
                               dropout_rate=RATE, dropout_seed=SEED)
    assert torch.equal(wrapped, out)
    for g, w in zip(torch.autograd.grad(wrapped, (q, k, v), do), got):
        assert torch.equal(g, w)


def test_dropout_mask_identity_of_the_plain_versions():
    share = check_mask_identity("cpu")
    assert 0.7 < share < 0.8
