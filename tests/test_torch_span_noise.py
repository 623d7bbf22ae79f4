"""The port's host-side noise and the objectives it feeds against the JAX
package: the word noise and batch concatenation of `data/noise.py`, the
span masking of `data/span_masking.py` and the three loader transforms,
each exactly, from the same ``RandomState`` seed, with the generator left
in the same state; ``token_embeds`` through `encode_joint` and
`encode_text` against the flax model and against the default word lookup;
`pc_loss` and `mass_loss` with every gradient leaf against
`jax.value_and_grad` on a small fp32 config."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.data import loader as jax_loader
from m3p_tpu.data import noise as jax_noise
from m3p_tpu.data import span_masking as jax_span
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.train import steps as jax_steps
from m3p_tpu_torch.checkpoint import grads_from_jax, params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data import loader, noise, span_masking, synthetic
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.transformer import lengths_to_mask
from m3p_tpu_torch.train import steps

torch.set_num_threads(1)

N_WORDS, N_LANGS = 512, 3
MASK = N_WORDS - 1
B, S, REGIONS = 6, 20, 8
# fp32 on both sides; the two frameworks sum in other orders
TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL = 1e-4
# a key bias's gradient is zero up to rounding (see test_torch_train.py)
ZERO_GRAD_LEAF = "k_lin.bias"
ZERO_GRAD_RTOL = 1e-6


def _tokens(seed, b=B, s=S, min_len=5):
    """BOS ... EOS rows of 5 to ``s`` tokens, padded."""
    return synthetic._random_tokens(np.random.RandomState(seed), b, s,
                                    N_WORDS, min_len)


def _assert_same(got, want, where="out"):
    """Equal structure, dtypes and values, bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            _assert_same(got[key], want[key], f"{where}[{key}]")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)


def _feats(seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, REGIONS, 16).astype(np.float32)
    img_len = np.array([8, 5, 1, 8, 3, 8], np.int32)
    return feats, img_len


# (function of (module, rng)) of each host function, on one batch
HOST = {
    "word_shuffle": lambda m, rng: m.word_shuffle(rng, *_tokens(0), 3.0),
    "word_shuffle_off": lambda m, rng: m.word_shuffle(rng, *_tokens(0), 0),
    "word_dropout": lambda m, rng: m.word_dropout(rng, *_tokens(1), 0.3),
    # nearly every word dropped: the keep-one-word fallback draws
    "word_dropout_fallback": lambda m, rng: m.word_dropout(
        rng, *_tokens(1), 0.97),
    "word_blank": lambda m, rng: m.word_blank(rng, *_tokens(2), 0.3, MASK),
    "add_noise": lambda m, rng: m.add_noise(rng, *_tokens(3), 3.0, 0.1,
                                            0.2, MASK),
    "add_noise_no_blank": lambda m, rng: m.add_noise(rng, *_tokens(3)),
    "concat_batches": lambda m, rng: m.concat_batches(
        *_tokens(4), 1, *_tokens(5), 2),
    "concat_batches_reset_positions": lambda m, rng: m.concat_batches(
        *_tokens(4), 1, *_tokens(5), 2, reset_positions=True),
    "mass_mask": lambda m, rng: m.mass_mask(rng, *_tokens(6), 0.5, MASK,
                                            N_WORDS),
    "mass_mask_short_span": lambda m, rng: m.mass_mask(
        rng, *_tokens(6, min_len=3), 0.1, MASK, N_WORDS),
    "bart_infill": lambda m, rng: m.bart_infill(rng, *_tokens(7), MASK),
    "poisson_region_noise": lambda m, rng: m.poisson_region_noise(
        rng, *_feats(8)),
}
MODULE = {"word_shuffle": "noise", "word_dropout": "noise",
          "word_blank": "noise", "add_noise": "noise",
          "concat_batches": "noise", "mass_mask": "span",
          "bart_infill": "span", "poisson_region_noise": "span"}


@pytest.mark.parametrize("name", list(HOST))
def test_host_function_is_the_jax_packages_bit_for_bit(name):
    kind = MODULE[next(k for k in MODULE if name.startswith(k))]
    port, jax_module = ((noise, jax_noise) if kind == "noise"
                        else (span_masking, jax_span))
    rng_port, rng_jax = np.random.RandomState(11), np.random.RandomState(11)
    got = HOST[name](port, rng_port)
    want = HOST[name](jax_module, rng_jax)
    _assert_same(got, want)
    # the same number of draws: the generators stay in step
    assert rng_port.randint(2 ** 31) == rng_jax.randint(2 ** 31)


def test_host_functions_change_what_they_should():
    """The comparisons above are not vacuous."""
    toks, lens = _tokens(0)
    rng = np.random.RandomState(11)
    assert not np.array_equal(noise.word_shuffle(rng, toks, lens, 3.0), toks)
    dropped, new_lens = noise.word_dropout(rng, toks, lens, 0.97)
    assert (new_lens == 3).all() and (dropped[:, 0] == toks[:, 0]).all()
    mass = span_masking.mass_mask(rng, toks, lens, 0.5, MASK, N_WORDS)
    assert (mass["enc_tokens"] != toks).any()
    np.testing.assert_array_equal(mass["dec_pos"][:, 1:],
                                  mass["dec_pos"][:, :-1] + 1)
    feats, img_len = _feats(8)
    out = span_masking.poisson_region_noise(rng, feats, img_len)
    assert (out == 0).all(-1).any(-1).all()


STREAM = {"tokens": _tokens(9, b=4, s=24)[0],
          "lengths": _tokens(9, b=4, s=24)[1]}
TRANSFORMS = {
    "mass": lambda m: m.make_mass_transform(0.5, MASK, N_WORDS),
    "bart": lambda m: m.make_bart_transform(MASK),
    "bart_use_noise": lambda m: m.make_bart_transform(
        MASK, noise=(3.0, 0.1, 0.1)),
    "ae": lambda m: m.make_ae_transform(2.0, 0.1, 0.1, MASK),
}


@pytest.mark.parametrize("lang_id", [None, 2])
@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_loader_transform_is_the_jax_packages(name, lang_id):
    rng_port, rng_jax = np.random.RandomState(5), np.random.RandomState(5)
    got = TRANSFORMS[name](loader)(rng_port, dict(STREAM), lang_id)
    want = TRANSFORMS[name](jax_loader)(rng_jax, dict(STREAM), lang_id)
    _assert_same(got, want)
    assert rng_port.randint(2 ** 31) == rng_jax.randint(2 ** 31)
    assert any(k.endswith("langs") for k in got) == (lang_id is not None)


# ---------------------------------------------------------------------------
# the model and the losses
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """2 layers, 64d, 4 heads, 1 refiner layer, 8 regions, its JAX model
    and parameters, and the port's model with the same weights."""
    jcfg = JaxModelConfig(
        n_words=N_WORDS, n_langs=N_LANGS, emb_dim=64, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
        refine_layers=1, mask_index=MASK, dtype="float32",
        use_pallas_attention=False)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = build_model(cfg, 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, model


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _embed_inputs():
    rng = np.random.RandomState(3)
    toks, lens = _tokens(12, b=3, s=12)
    feats = rng.randn(3, REGIONS, 2048).astype(np.float32)
    locs = rng.rand(3, REGIONS, 5).astype(np.float32)
    img_len = np.array([8, 5, 8], np.int32)
    embeds = 0.1 * rng.randn(3, 12, 64).astype(np.float32)
    langs = rng.randint(0, N_LANGS, (3, 12)).astype(np.int32)
    return toks, lens, feats, locs, img_len, embeds, langs


@pytest.mark.parametrize("which", ["encode_joint", "encode_text"])
def test_token_embeds_match_jax_and_the_word_lookup(small, which):
    jm, params, model = small
    toks, lens, feats, locs, img_len, embeds, langs = _embed_inputs()
    text_mask = lengths_to_mask(_t(lens), toks.shape[1])
    img_mask = lengths_to_mask(_t(img_len), REGIONS)
    jtext = np.asarray(text_mask.numpy())
    jimg = np.asarray(img_mask.numpy())
    if which == "encode_joint":
        want = jm.apply({"params": params}, toks, jtext, feats, locs, jimg,
                        True, token_embeds=jnp.asarray(embeds),
                        method=jm.encode_joint)

        def port(token_embeds):
            return model.encode_joint(_t(toks).long(), text_mask, _t(feats),
                                      _t(locs), img_mask, True,
                                      token_embeds=token_embeds)
    else:
        want, _ = jm.apply({"params": params}, toks, jtext, langs,
                           token_embeds=jnp.asarray(embeds),
                           method=jm.encode_text)

        def port(token_embeds):
            return model.encode_text(_t(toks).long(), text_mask,
                                     _t(langs).long(),
                                     token_embeds=token_embeds)
    with torch.no_grad():
        got = port(_t(embeds))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        lookup = model.embed_tokens(_t(toks).long())
        torch.testing.assert_close(port(lookup), port(None), rtol=0, atol=0)
        assert (got - port(None)).abs().max() > 1e-2


def _pc_batch():
    rng = np.random.RandomState(13)
    x1, l1 = _tokens(14, b=4, s=16)
    x2, l2 = _tokens(15, b=4, s=16)
    toks, lens, pos, langs = noise.concat_batches(x1, l1, 1, x2, l2, 2)
    return {"tokens": toks, "lengths": lens, "positions": pos,
            "langs": langs,
            "labels": np.array([1, 0, 1, 0], np.int32)}


def _mass_batch():
    toks, lens = _tokens(16, b=4, s=20, min_len=12)
    batch = loader.make_mass_transform(0.5, MASK, N_WORDS)(
        np.random.RandomState(17), {"tokens": toks, "lengths": lens}, 1)
    return batch


# (port loss, JAX loss, batch, metric names)
LOSSES = {
    "pc": (steps.pc_loss, jax_steps.pc_loss, _pc_batch(), {"pc", "acc"}),
    "mass": (steps.mass_loss, jax_steps.mass_loss, _mass_batch(),
             {"mass"}),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_and_every_gradient_leaf_match_jax(small, name):
    jm, params, _ = small
    port_loss, jax_loss, batch, names = LOSSES[name]
    jloss = functools.partial(jax_loss, jm, deterministic=True)
    (want_loss, want_metrics), want_grads = jax.value_and_grad(
        lambda p: jloss(p, jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(1)), has_aux=True)(params)
    model = build_model(ModelConfig(**dataclasses.asdict(jm.cfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    loss, metrics = port_loss(model, {k: _t(v) for k, v in batch.items()},
                              None, deterministic=True)
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
    assert (len(cross) == 2 * 8) == (name == "mass"), cross
    assert got["text_emb.lang.weight"] is not None
    if name == "pc":        # the classifier's rows of the word table
        word = got["text_emb.word.weight"]
        assert word[8].abs().max() > 0 and word[9, 0] != 0
    assert reached >= 30
