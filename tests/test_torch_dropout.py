"""The port's fused residual dropout (m3p_tpu_torch.ops.dropout, the flat
Philox mask of ops.philox, and EncoderBlock with use_fused_dropout) on the
CPU, where the plain versions run.

The JAX kernels draw from the TPU's hardware PRNG, which has no CPU
lowering (tests/test_fused_dropout.py runs them on a TPU only), so the port
is held to the JAX semantics by the properties that file tests: the keep
rate, kept values equal to residual + x * scale with the scale rounded to
x's dtype, determinism per seed, the backward regenerating the forward's
mask, dres = g, and identity when deterministic or at rate 0.  The fused
EncoderBlock is compared with the JAX block at deterministic=True, and at
rate 0.1 with a hand composition of the plain `dropout_add`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from m3p_tpu.model import layers as jlayers
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.model import layers as tlayers
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.ops import philox
from m3p_tpu_torch.ops.dropout import (
    dropout_add, dropout_add_reference, dropout_scale,
    dropout_scale_reference, fused_dropout_add)
from m3p_tpu_torch.ops.philox import (
    keep_mask_flat, keep_threshold, philox4x32, seed_key)

torch.set_num_threads(1)

SEED = 0x1234_5678_9ABC_DEF0
RATE = 0.1
DTYPES = [torch.float32, torch.bfloat16]
# a keep share within 5 standard deviations of 1 - rate
SIGMAS = 5.0
B, S, D, H, F = 2, 9, 24, 3, 48


def _share_ok(kept: torch.Tensor, rate: float) -> bool:
    n = kept.numel()
    sd = (rate * (1.0 - rate) / n) ** 0.5
    return abs(kept.float().mean().item() - (1.0 - rate)) < SIGMAS * sd


@pytest.mark.parametrize("first", [0, 5, 2 ** 34 + 3])
def test_keep_mask_flat_known_answers(first):
    """Element i takes word i % 4 of Philox4x32-10 at counter (i // 4 lo,
    i // 4 hi, 0, 0) under the seed's key; kept at or above the
    threshold."""
    n, rate = 37, 0.3
    got = keep_mask_flat(SEED, n, rate, first=first)
    idx = torch.arange(first, first + n, dtype=torch.int64)
    group = idx // 4
    words = torch.stack(philox4x32(group & 0xFFFFFFFF, group >> 32, 0, 0,
                                   *seed_key(SEED)), dim=-1)
    bits = words.gather(1, (idx % 4)[:, None])[:, 0]
    assert torch.equal(got, bits >= keep_threshold(rate))
    # word 0 of group 0 is the Random123 generator at counter 0
    if first == 0:
        w0 = philox4x32(0, 0, 0, 0, *seed_key(SEED))[0]
        assert bool(got[0]) == bool(w0 >= keep_threshold(rate))


def test_keep_mask_flat_does_not_depend_on_chunking(monkeypatch):
    n = 1001
    whole = keep_mask_flat(SEED, n, RATE)
    pieces = torch.cat([keep_mask_flat(SEED, b - a, RATE, first=a)
                        for a, b in ((0, 3), (3, 10), (10, 517),
                                     (517, 1001))])
    assert torch.equal(whole, pieces)
    monkeypatch.setattr(philox, "FLAT_CHUNK", 13)
    assert torch.equal(keep_mask_flat(SEED, n, RATE), whole)
    assert torch.equal(keep_mask_flat(SEED, 990, RATE, first=11),
                       whole[11:])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_flat_keep_rate_and_seeds(rate):
    kept = keep_mask_flat(SEED, 200_000, rate)
    assert _share_ok(kept, rate)
    assert torch.equal(kept, keep_mask_flat(SEED, 200_000, rate))
    assert not torch.equal(kept, keep_mask_flat(SEED + 1, 200_000, rate))
    assert not torch.equal(kept,
                           keep_mask_flat(SEED + (1 << 32), 200_000, rate))


def _inputs(dtype, shape=(4, 33, 130), seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) + 3.0)
    res = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return x.to(dtype), res.to(dtype)


def test_the_scale_is_rounded_to_the_dtype():
    """The TPU kernel multiplies by jnp.asarray(1/(1-rate), x.dtype): in
    bf16 at rate 0.1 that is 1.109375, 0.16 % under 1/0.9."""
    ones = torch.ones(4096, dtype=torch.bfloat16)
    kept = dropout_scale_reference(ones, SEED, RATE)
    assert set(kept.float().unique().tolist()) == {0.0, 1.109375}
    ones32 = torch.ones(4096)
    vals = dropout_scale_reference(ones32, SEED, RATE).unique()
    assert vals.tolist() == [0.0, torch.tensor(1 / 0.9).item()]


@pytest.mark.parametrize("dtype", DTYPES)
def test_unfused_dropout_keeps_flax_values(dtype):
    """The port's unfused `dropout` (flax ``nn.Dropout`` of the JAX model)
    gives every value both sides keep exactly flax's value, in fp32 and
    bf16 at rate 0.1: flax divides by 1 - rate held in x's dtype.  Flax's
    mask is read from its nonzeros on an input with no zeros."""
    rng = np.random.RandomState(3)
    x = rng.randn(200_000).astype(np.float32)
    x[x == 0] = 1.0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    flax_out = nn.Dropout(RATE).apply({}, jx, deterministic=False,
                                      rngs={"dropout": jax.random.key(0)})
    flax_out = torch.from_numpy(np.array(flax_out.astype(jnp.float32)))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
    out = tlayers.dropout(tx, RATE, False, Generators.from_seed(5, "cpu"))
    assert out.dtype == dtype
    flax_kept, port_kept = flax_out != 0, out != 0
    assert _share_ok(flax_kept, RATE) and _share_ok(port_kept, RATE)
    both = flax_kept & port_kept
    assert int(both.sum()) > 150_000
    assert torch.equal(out.float()[both], flax_out[both])
    assert torch.equal(out[~port_kept], torch.zeros_like(out[~port_kept]))
    # the check has teeth: a product with 1 / (1 - rate) differs from flax
    product = (tx * (1.0 / (1.0 - RATE))).float()
    assert int((product[both] != flax_out[both]).sum()) > 1000


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_add_keeps_at_the_rate_with_the_dtype_scale(dtype, rate):
    x, res = _inputs(dtype)
    out = dropout_add(x, res, SEED, rate)
    assert out.dtype == dtype and out.shape == x.shape
    keep = keep_mask_flat(SEED, x.numel(), rate).view(x.shape)
    assert _share_ok(keep, rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=dtype).float()
    prod = (x.float() * scale).to(dtype)        # one rounding
    want = (res.float() + prod.float()).to(dtype)
    assert torch.equal(out[keep], want[keep])
    assert torch.equal(out[~keep], res[~keep])
    # determinism per seed, and another seed another mask
    assert torch.equal(out, dropout_add(x, res, SEED, rate))
    assert not torch.equal(out, dropout_add(x, res, SEED + 1, rate))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_add_backward_regenerates_the_mask(dtype):
    x, res = _inputs(dtype, shape=(3, 17, 64), seed=1)
    x.requires_grad_(True)
    res.requires_grad_(True)
    out = dropout_add(x, res, SEED, 0.5)
    g = torch.full_like(out, 2.0)
    dx, dres = torch.autograd.grad(out, (x, res), g)
    kept = out.detach() != res.detach()
    assert torch.equal(dx != 0, kept)
    assert (dx[kept] == 4.0).all()
    assert torch.equal(dres, g)
    # the backward is dropout_scale of g under the same seed
    assert torch.equal(dx, dropout_scale_reference(g, SEED, 0.5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_scale_forward_and_backward_share_the_mask(dtype):
    x, _ = _inputs(dtype, shape=(8, 128), seed=2)
    x.requires_grad_(True)
    out = dropout_scale(x, SEED, 0.5)
    kept = out.detach() != 0
    assert _share_ok(kept, 0.5)
    assert torch.equal(out.detach()[kept], (x.detach() * 2.0)[kept])
    (dx,) = torch.autograd.grad(out, (x,), torch.ones_like(out))
    assert torch.equal(dx != 0, kept) and (dx[kept] == 2.0).all()


def test_dispatcher_identity_and_argument_checks():
    x, res = _inputs(torch.float32, shape=(8, 128))
    for kw in (dict(deterministic=True), dict(rate=0.0)):
        args = dict(seed=3, rate=0.5, deterministic=False)
        args.update(kw)
        assert torch.equal(fused_dropout_add(x, res, **args), res + x)
    assert torch.equal(fused_dropout_add(x, res, 3, 0.5),
                       dropout_add_reference(x, res, 3, 0.5))
    with pytest.raises(ValueError, match="64-bit"):
        dropout_add(x, res, -1, 0.5)
    with pytest.raises(ValueError, match="rate"):
        dropout_add(x, res, 3, 1.0)
    with pytest.raises(ValueError, match="must match"):
        dropout_add(x, res.double(), 3, 0.5)
    with pytest.raises(ValueError, match="must match"):
        dropout_add(x, res[:4], 3, 0.5)


# ---------------------------------------------------------------------------
# the fused EncoderBlock
# ---------------------------------------------------------------------------


def _mask(lens, s):
    return np.arange(s)[None, :] < np.asarray(lens)[:, None]


@pytest.fixture(scope="module")
def block_params():
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, D).astype(np.float32)
    mask = _mask([S, 4], S)
    jblk = jlayers.EncoderBlock(n_heads=H, dim=D, ffn_dim=F,
                                has_cross_attention=True, use_pallas=False,
                                dropout=RATE, fused_dropout=True)
    params = nn.meta.unbox(jblk.init(jax.random.PRNGKey(0), x, mask, False,
                                     jnp.asarray(x), mask)["params"])
    params = jax.tree.map(
        lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape), p.dtype), params)
    return jblk, params, x, mask


def _port_block(params, dropout=RATE, attention_dropout=0.0):
    blk = tlayers.EncoderBlock(H, D, F, True, True, dropout=dropout,
                               attention_dropout=attention_dropout,
                               use_fused_dropout=True)
    blk.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                        strict=True)
    return blk


def test_fused_encoder_block_matches_jax_at_deterministic(block_params):
    """Output and every gradient (parameters and input) of the block built
    with use_fused_dropout against the JAX block, deterministic=True."""
    jblk, params, x, mask = block_params
    w = np.random.RandomState(1).randn(B, S, D).astype(np.float32)

    def jloss(p, xx):
        out = jblk.apply({"params": p}, xx, mask, deterministic=True)[0]
        return jnp.sum(out * w), out

    (_, want), (jgrads, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    blk = _port_block(params)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = blk(tx, torch.from_numpy(mask), deterministic=True)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in blk.named_parameters():
        if p.grad is None:        # the cross-attention, unused here
            assert not want_grads[name].any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_fused_encoder_block_is_the_plain_dropout_add_composed(block_params):
    """At rate 0.1 the fused block equals LN1(dropout_add(attn, x)), the
    FFN without its own dropout, LN2(dropout_add(ffn, x)), with the seeds
    drawn from the same host generator; gradients too."""
    _, params, x, mask = block_params
    blk = _port_block(params, attention_dropout=RATE)
    tmask = torch.from_numpy(mask)

    def run(fn):
        tx = torch.from_numpy(x).requires_grad_(True)
        out = fn(tx, Generators.from_seed(7, "cpu"))
        out.sum().backward()
        grads = [tx.grad] + [p.grad.clone() for p in blk.parameters()
                             if p.grad is not None]
        blk.zero_grad(set_to_none=True)
        return out.detach(), grads

    def by_hand(tx, gens):
        attn = blk.attn(tx, tmask, False, False, gens)
        h = blk.ln1(dropout_add_reference(attn, tx, gens.dropout_seed(),
                                          RATE))
        f = blk.ffn(h, False, gens, skip_dropout=True)
        h = blk.ln2(dropout_add_reference(f, h, gens.dropout_seed(), RATE))
        return h * tmask[..., None].float()

    fused, fused_grads = run(lambda tx, g: blk(tx, tmask, False, False, g))
    hand, hand_grads = run(by_hand)
    assert torch.equal(fused, hand)
    for a, b in zip(fused_grads, hand_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # dropout is on: a deterministic forward differs, another seed too
    with torch.no_grad():
        det = blk(torch.from_numpy(x), tmask, deterministic=True)
        other = blk(torch.from_numpy(x), tmask, False, False,
                    Generators.from_seed(8, "cpu"))
    assert not torch.equal(fused, det) and not torch.equal(fused, other)


def test_fused_block_draws_no_device_masks_and_needs_generators(
        block_params):
    _, params, x, mask = block_params
    blk = _port_block(params)
    gens = Generators.from_seed(3, "cpu")
    before = gens.device.get_state()
    with torch.no_grad():
        blk(torch.from_numpy(x), torch.from_numpy(mask), False, False, gens)
    assert torch.equal(gens.device.get_state(), before)
    with pytest.raises(ValueError, match="generators"):
        blk(torch.from_numpy(x), torch.from_numpy(mask), False, False, None)
