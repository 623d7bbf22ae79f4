"""The port's decoder-training path against the JAX package on a small fp32
config: the caption, MT and slide batch builders; cross-attention in
`MultiHeadAttention` (Sq != Sk, a padded key row) and the decoder
`EncoderBlock` (causal, with a source encoding) against the flax modules;
the fused decoder block at rate 0.1 against a hand composition of the
plain `dropout_add`; the decoder topologies (`encode_text` causal with
`src_enc`, `encode_image` with and without `refine_encoder`,
`decode_image`); the seven losses (`caption_loss`, `mt_loss`,
`mt_caption_loss`, `clm_loss` with and without a context, `tifg_loss`,
`slide_loss`, and `caption_loss` with `refine_encoder`), each loss and
every gradient leaf against `jax.value_and_grad`; three `make_train_step`
steps of `caption_loss` against the JAX step.  deterministic=True wherever
the two are compared: the port draws other random numbers than JAX."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model import layers as jlayers
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train import steps as jax_steps
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch.checkpoint import grads_from_jax, params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data import synthetic
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model import layers as tlayers
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.ops.dropout import dropout_add_reference
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train import steps
from m3p_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

N_WORDS, N_LANGS = 512, 3
BATCH, TEXT_LEN, REGIONS = 3, 16, 8
# fp32 on both sides; the two frameworks sum in other orders
TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL = 1e-4
# a key bias's gradient is zero up to rounding (see test_torch_train.py),
# in cross-attention as in self-attention
ZERO_GRAD_LEAF = "k_lin.bias"
ZERO_GRAD_RTOL = 1e-6
# the single modules: B, Sq, Sk, D, H, FFN width
B, SQ, SK, D, H, F = 2, 10, 37, 24, 3, 48
RATE = 0.1


def _mask(lens, s):
    return np.arange(s)[None, :] < np.asarray(lens)[:, None]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def small():
    """2 layers, 64d, 4 heads, 1 refiner layer, 8 regions, its JAX model
    and parameters, and the port's model with the same weights."""
    jcfg = JaxModelConfig(
        n_words=N_WORDS, n_langs=N_LANGS, emb_dim=64, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
        refine_layers=1, mask_index=N_WORDS - 1, dtype="float32",
        use_pallas_attention=False)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return jcfg, jm, params, _port(jcfg, params)


def _port(jcfg, params, **changes):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = build_model(dataclasses.replace(cfg, **changes), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


BUILDERS = {
    "caption": lambda m, rng: m.make_caption_batch(rng, 5, 64, 100, 250002),
    "mt": lambda m, rng: m.make_mt_batch(rng, 5, 64, 250002),
    "slide": lambda m, rng: m.make_slide_batch(rng, 5, 64, 100, 250002),
}


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_synthetic_batch_is_the_jax_packages(kind):
    want = BUILDERS[kind](jax_synthetic, np.random.RandomState(3))
    got = BUILDERS[kind](synthetic, np.random.RandomState(3))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def _batches():
    """One small batch of each objective, from one seed: captions (tgt_len)
    over images with padded regions in one row, translation pairs with
    language ids, a multimodal pair, CLM streams with a short row, slide
    pairs."""
    rng = np.random.RandomState(0)
    cap = synthetic.make_caption_batch(rng, BATCH, TEXT_LEN, REGIONS, N_WORDS)
    cap["img_len"][1] = 5
    mt = synthetic.make_mt_batch(rng, BATCH, TEXT_LEN, N_WORDS)
    mt["src_langs"] = rng.randint(0, N_LANGS, (BATCH, TEXT_LEN)).astype(
        np.int32)
    mt["tgt_langs"] = rng.randint(0, N_LANGS, (BATCH, TEXT_LEN)).astype(
        np.int32)
    mmt = dict(synthetic.make_mt_batch(rng, BATCH, TEXT_LEN, N_WORDS),
               feats=cap["feats"], locs=cap["locs"], img_len=cap["img_len"])
    clm = synthetic.make_stream_batch(rng, BATCH, TEXT_LEN, N_WORDS)
    clm["lengths"][2] = 9
    slide = synthetic.make_slide_batch(rng, BATCH, TEXT_LEN, REGIONS,
                                       N_WORDS)
    slide["img_len"][0] = 3
    return {"caption": cap, "mt": mt, "mt_caption": mmt, "clm": clm,
            "slide": slide}


BATCHES = _batches()

# (port loss, JAX loss, batch, keyword arguments of both, metric names)
LOSSES = {
    "caption": (steps.caption_loss, jax_steps.caption_loss, "caption", {},
                {"ce", "acc", "n_words"}),
    "caption_refine_encoder": (steps.caption_loss, jax_steps.caption_loss,
                               "caption", dict(refine_encoder=True),
                               {"ce", "acc", "n_words"}),
    "mt": (steps.mt_loss, jax_steps.mt_loss, "mt", {},
           {"ce", "acc", "n_words"}),
    "mt_caption": (steps.mt_caption_loss, jax_steps.mt_caption_loss,
                   "mt_caption", {}, {"ce", "acc", "n_words"}),
    "clm": (steps.clm_loss, jax_steps.clm_loss, "clm", {}, {"clm", "acc"}),
    "clm_context_3": (steps.clm_loss, jax_steps.clm_loss, "clm",
                      dict(context_size=3), {"clm", "acc"}),
    "tifg": (steps.tifg_loss, jax_steps.tifg_loss, "caption", {}, {"tifg"}),
    "slide": (steps.slide_loss, jax_steps.slide_loss, "slide", {},
              {"loss", "acc"}),
}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _init(module, *args):
    return nn.meta.unbox(module.init(*args)["params"])


def _load(module, jax_params):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        jax_params)),
                           strict=True)
    return module


def _perturbed(params, rng):
    """Non-trivial LayerNorm parameters and biases."""
    return jax.tree.map(
        lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape), p.dtype), params)


def _module_inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(B, SQ, D).astype(np.float32)
    src = rng.randn(B, SK, D).astype(np.float32)
    w = rng.randn(B, SQ, D).astype(np.float32)
    # a padded key row in the source, a short target row
    return x, src, w, _mask([SQ, 6], SQ), _mask([SK, 20], SK)


def _assert_grads(port_module, jax_grads):
    want = params_from_jax(jax.tree.map(np.asarray, jax_grads))
    for name, p in port_module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_cross_attention_matches_jax():
    """Sq = 10 queries over Sk = 37 keys with a padded key row: output and
    the gradients of the queries' input, the source and every
    parameter."""
    x, src, w, _, smask = _module_inputs()
    jm = jlayers.MultiHeadAttention(n_heads=H, dim=D, use_pallas=False)
    params = _perturbed(_init(jm, jax.random.PRNGKey(0), x, smask, src),
                        np.random.RandomState(1))

    def jloss(p, xx, ss):
        out = jm.apply({"params": p}, xx, smask, kv=ss,
                       deterministic=True)[0]
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(params, x, src)
    tm = _load(tlayers.MultiHeadAttention(H, D), params)
    tx, ts = (_t(a).requires_grad_(True) for a in (x, src))
    out = tm(tx, _t(smask), kv=ts)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for got, g in ((tx.grad, jgrads[1]), (ts.grad, jgrads[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)
    _assert_grads(tm, jgrads[0])
    # the padded keys take no part: changing them leaves the output alone
    ts2 = ts.detach().clone()
    ts2[1, 20:] = 100.0
    with torch.no_grad():
        torch.testing.assert_close(tm(tx, _t(smask), kv=ts2), out.detach())


@pytest.fixture(scope="module")
def decoder_block():
    x, src, w, mask, smask = _module_inputs()
    jblk = jlayers.EncoderBlock(n_heads=H, dim=D, ffn_dim=F,
                                has_cross_attention=True, use_pallas=False,
                                dropout=RATE, fused_dropout=True)
    params = _perturbed(_init(jblk, jax.random.PRNGKey(0), x, mask, True,
                              src, smask), np.random.RandomState(2))
    return jblk, params


def _port_block(params, **kw):
    return _load(tlayers.EncoderBlock(H, D, F, True, True, **kw), params)


def test_decoder_block_matches_jax(decoder_block):
    """The block causal with cross-attention over a source encoding, built
    with use_fused_dropout, at deterministic=True: output and every
    gradient (parameters, input, source) against the JAX block."""
    jblk, params = decoder_block
    x, src, w, mask, smask = _module_inputs()

    def jloss(p, xx, ss):
        out = jblk.apply({"params": p}, xx, mask, True, ss, smask,
                         deterministic=True)[0]
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(params, x, src)
    blk = _port_block(params, dropout=RATE, use_fused_dropout=True)
    tx, ts = (_t(a).requires_grad_(True) for a in (x, src))
    out = blk(tx, _t(mask), True, src_enc=ts, src_mask=_t(smask))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for got, g in ((tx.grad, jgrads[1]), (ts.grad, jgrads[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)
    _assert_grads(blk, jgrads[0])
    # the future takes no part: changing the last position leaves the
    # others alone
    tx2 = tx.detach().clone()
    tx2[:, -1] += 10.0
    with torch.no_grad():
        out2 = blk(tx2, _t(mask), True, src_enc=ts, src_mask=_t(smask))
    torch.testing.assert_close(out2[:, :-1], out.detach()[:, :-1])


def test_fused_decoder_block_is_the_plain_dropout_add_composed(
        decoder_block):
    """At rate 0.1 the fused decoder block equals LN1(dropout_add(attn,
    x)), LN15(dropout_add(cross, .)), the FFN without its own dropout,
    LN2(dropout_add(ffn, .)), three seeds drawn from one host generator;
    gradients too."""
    _, params = decoder_block
    x, src, _, mask, smask = _module_inputs()
    blk = _port_block(params, dropout=RATE, attention_dropout=RATE,
                      use_fused_dropout=True)
    tmask, tsmask = _t(mask), _t(smask)

    def run(fn):
        tx, ts = (_t(a).requires_grad_(True) for a in (x, src))
        out = fn(tx, ts, Generators.from_seed(7, "cpu"))
        out.sum().backward()
        grads = [tx.grad, ts.grad] + [p.grad.clone()
                                      for p in blk.parameters()]
        blk.zero_grad(set_to_none=True)
        return out.detach(), grads

    def by_hand(tx, ts, gens):
        attn = blk.attn(tx, tmask, True, False, gens)
        h = blk.ln1(dropout_add_reference(attn, tx, gens.dropout_seed(),
                                          RATE))
        cross = blk.encoder_attn(h, tsmask, False, False, gens, kv=ts)
        h = blk.ln15(dropout_add_reference(cross, h, gens.dropout_seed(),
                                           RATE))
        f = blk.ffn(h, False, gens, skip_dropout=True)
        h = blk.ln2(dropout_add_reference(f, h, gens.dropout_seed(), RATE))
        return h * tmask[..., None].float()

    fused, fused_grads = run(lambda tx, ts, g: blk(
        tx, tmask, True, False, g, src_enc=ts, src_mask=tsmask))
    hand, hand_grads = run(by_hand)
    assert torch.equal(fused, hand)
    for a, b in zip(fused_grads, hand_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        det = blk(_t(x), tmask, True, src_enc=_t(src), src_mask=tsmask)
    assert not torch.equal(fused, det)


# ---------------------------------------------------------------------------
# the model's decoder topologies
# ---------------------------------------------------------------------------


def _topology(model, jm, params, which):
    """(port output, JAX output) of one topology on the caption batch."""
    b = BATCHES["caption"]
    tokens, feats, locs = b["tokens"], b["feats"], b["locs"]
    tmask = _mask(b["tgt_len"], TEXT_LEN)
    imask = _mask(b["img_len"], REGIONS)
    rng = np.random.RandomState(5)
    enc = rng.randn(BATCH, REGIONS, 64).astype(np.float32)
    txt = rng.randn(BATCH, TEXT_LEN - 4, 64).astype(np.float32)
    txt_mask = tmask[:, :TEXT_LEN - 4]
    v = {"params": params}
    with torch.no_grad():
        if which == "encode_text":
            want, _ = jm.apply(v, tokens, tmask, None, None, True, enc, imask,
                               method=jm.encode_text)
            got = model.encode_text(_t(tokens).long(), _t(tmask), causal=True,
                                    src_enc=_t(enc), src_mask=_t(imask))
        elif which.startswith("encode_image"):
            again = which.endswith("refine_encoder")
            want = jm.apply(v, feats, locs, imask, None, True,
                            refine_encoder=again, method=jm.encode_image)
            got = model.encode_image(_t(feats), _t(locs), _t(imask), True,
                                     refine_encoder=again)
        else:
            want = jm.apply(v, feats, locs, imask, txt, txt_mask,
                            method=jm.decode_image)
            got = model.decode_image(_t(feats), _t(locs), _t(imask), _t(txt),
                                     _t(txt_mask))
    return got, want


@pytest.mark.parametrize("which", ["encode_text", "encode_image",
                                   "encode_image_refine_encoder",
                                   "decode_image"])
def test_decoder_topologies_match_jax(small, which):
    _, jm, params, model = small
    got, want = _topology(model, jm, params, which)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_and_every_gradient_leaf_match_jax(small, name):
    jcfg, jm, params, _ = small
    port_loss, jax_loss, batch_name, kw, names = LOSSES[name]
    batch = BATCHES[batch_name]
    jloss = functools.partial(jax_loss, jm, deterministic=True, **kw)
    (want_loss, want_metrics), want_grads = jax.value_and_grad(
        lambda p: jloss(p, jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(1)), has_aux=True)(params)
    model = _port(jcfg, params)
    loss, metrics = port_loss(model, _torch_batch(batch), None,
                              deterministic=True, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    assert set(metrics) == set(want_metrics) == names
    for key in names:
        np.testing.assert_allclose(metrics[key].item(),
                                   float(want_metrics[key]), **TOL,
                                   err_msg=key)
    want = grads_from_jax(jax.tree.map(np.asarray, want_grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    largest = max(w.abs().max().item() for w in want.values())
    reached = 0
    for leaf, w in want.items():
        g = got[leaf]
        if g is None:       # a head or stream this objective does not use
            assert not w.any(), leaf
            continue
        reached += 1
        if leaf.endswith(ZERO_GRAD_LEAF):
            for x in (g, w):
                assert x.abs().max().item() < ZERO_GRAD_RTOL * largest, leaf
            continue
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert err < GRAD_RTOL, (leaf, err)
    cross = [n for n in got if ".encoder_attn." in n and got[n] is not None]
    decoder = not name.startswith(("clm", "slide"))
    assert (len(cross) == 2 * 8) == decoder, cross
    assert reached >= 30


def test_three_caption_train_steps_match_jax(small):
    """make_train_step over caption_loss with clip 5.0 + adam_inverse_sqrt
    (the optimizer of `chip_smoke.py`'s decoder phase) against the JAX
    step: loss, gradient norm and every parameter after each of three
    steps (eps = 1e-3 for the reason test_torch_train.py gives)."""
    jcfg, jm, params, _ = small
    batch = BATCHES["caption"]
    spec = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.001,"
            "warmup_updates=2,eps=0.001")
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=5.0)
    jstate = jax_train_state(jax.tree.map(jnp.asarray, params), tx)
    jloss = functools.partial(jax_steps.caption_loss, jm, deterministic=True)
    jax_step = jax_steps.make_train_step(
        lambda p, b, key: jloss(p, b, key), donate=False,
        with_grad_norm=True)
    model = _port(jcfg, params)
    ttx, _ = optim.build_optimizer(spec, clip_grad_norm=5.0)
    state = create_train_state(model, ttx)
    step = steps.make_train_step(functools.partial(
        steps.caption_loss, deterministic=True), with_grad_norm=True)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = _torch_batch(batch)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        jstate, jmetrics = jax_step(jstate, jb, jax.random.PRNGKey(10 + i))
        state, metrics = step(state, tb, None)
        assert state.step == int(jstate.step) == i + 1
        for key in ("ce", "acc", "grad_norm"):
            np.testing.assert_allclose(metrics[key].item(),
                                       float(jmetrics[key]), rtol=1e-4,
                                       err_msg=f"{key} step {i}")
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=f"{name} step {i}")
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > 1e-4


@pytest.mark.parametrize("name", list(LOSSES))
def test_training_forward_draws_from_the_generators(small, name):
    """deterministic=False: the same seed gives the same loss, another
    seed another; without generators the loss raises."""
    jcfg, _, params, _ = small
    model = _port(jcfg, params, dropout=0.1, attention_dropout=0.1,
                  use_fused_dropout=True)
    port_loss, _, batch_name, kw, _ = LOSSES[name]
    tb = _torch_batch(BATCHES[batch_name])

    def loss(seed):
        with torch.no_grad():
            return port_loss(model, tb, Generators.from_seed(seed, "cpu"),
                             **kw)[0].item()

    assert loss(7) == loss(7) != loss(8)
    with pytest.raises(ValueError, match="generators"):
        port_loss(model, tb, None, **kw)
