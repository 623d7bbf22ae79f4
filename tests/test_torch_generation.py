"""The port's generation against the JAX package on `small_test_config()`
in fp32 (2 layers, 64d, 4 heads, 512 words), weights moved over by
`params_from_jax`: the decode caches, the attention cache branch
(self-attention written at a position, cross-attention from the cache,
the beam fold), the decode step teacher-forced, greedy decoding and beam
search token for token, the batched stable top-k, sampling's properties,
the flash route at 514 cached positions, and the no-cache paths.

A second copy of the weights raises the word head's EOS bias by
``EOS_BIAS`` (in both frameworks), so that hypotheses finish at different
lengths and the finished pools, the length penalty and early stopping
decide the outcome.  Logits and caches agree within ``TOL`` (fp32, sums in
another order); tokens and lengths are equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.config import EOS_IDX, PAD_IDX, small_test_config
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model import generation as jgen
from m3p_tpu.model import layers as jlayers
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model import generation as tgen
from m3p_tpu_torch.model.layers import KVCache
from m3p_tpu_torch.ops import attention as ops
from m3p_tpu_torch.ops.topk import top_k

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 3, 6
EOS_BIAS = 3.25
MAX_LEN = 12


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(jcfg, params):
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _with_eos_bias(params):
    bias = params["pred_layer"]["bias"].copy()
    bias[EOS_IDX] += EOS_BIAS
    return {**params, "pred_layer": {**params["pred_layer"], "bias": bias}}


@pytest.fixture(scope="module")
def small():
    """The JAX model, its parameters plain and EOS-biased, the port's
    models with the same weights, and a source encoding (B = 3 rows of 6
    tokens, row 1 padded after 4) with its mask, computed by the port."""
    jcfg = small_test_config().model
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    eos_params = _with_eos_bias(params)
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, 500, (B, S))
    mask = np.ones((B, S), bool)
    mask[1, 4:] = False
    model = _port(jcfg, params)
    with torch.no_grad():
        enc = model.encode_text(_t(tokens).long(), _t(mask)).numpy()
    return {"jcfg": jcfg, "jm": jm, "params": params,
            "eos_params": eos_params, "model": model,
            "eos_model": _port(jcfg, eos_params), "enc": enc, "mask": mask}


def _models(small, eos):
    return ((small["eos_params"], small["eos_model"]) if eos
            else (small["params"], small["model"]))


# ---------------------------------------------------------------------------
# caches and the attention cache branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beams", [1, 3])
def test_init_decode_cache_matches_jax(small, beams):
    jm, enc, model = small["jm"], small["enc"], small["model"]
    bk = B * beams
    want = jm.apply({"params": small["params"]}, jnp.asarray(enc), MAX_LEN,
                    bk, method=jm.init_decode_cache)
    got = model.init_decode_cache(_t(enc), MAX_LEN, bk)
    assert got.pos == 0 and len(got.layers) == len(want)
    for i, layer in enumerate(got.layers):
        w = want[f"layer_{i}"]
        for name in ("k", "v"):
            kv = getattr(layer.self_kv, name)
            assert kv.shape == w["self"][name].shape == (bk, 4, MAX_LEN, 16)
            assert kv.dtype == torch.float32 and not kv.any()
            np.testing.assert_allclose(getattr(layer.cross_kv, name).numpy(),
                                       np.asarray(w["cross"][name]), **TOL)
            assert getattr(layer.cross_kv, name).shape[0] == B
    assert model.init_cache(2, 5).layers[0].cross_kv is None


def _mha(small):
    jm = jlayers.MultiHeadAttention(n_heads=4, dim=64, use_pallas=False)
    return (jm, {"params": small["params"]["block_0"]["attn"]},
            small["model"].blocks[0].attn)


@pytest.mark.parametrize("pos", [0, 3, MAX_LEN - 1])
def test_self_attention_cache_matches_jax(small, pos):
    """One step written at ``pos`` into a cache whose earlier positions
    hold random keys and values: the output and the updated cache."""
    jm, jv, tm = _mha(small)
    rng = np.random.RandomState(10 + pos)
    x = rng.randn(B, 1, 64).astype(np.float32)
    k0, v0 = (rng.randn(B, 4, MAX_LEN, 16).astype(np.float32)
              for _ in range(2))
    cache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
             "pos": jnp.array(pos, jnp.int32)}
    want, new = jm.apply(jv, jnp.asarray(x), jnp.ones((B, 1), bool),
                         cache=cache)
    kv = KVCache(_t(k0.copy()), _t(v0.copy()))
    with torch.no_grad():
        got = tm(_t(x), torch.ones(B, 1, dtype=torch.bool), cache=kv,
                 pos=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(kv.k.numpy(), np.asarray(new["k"]), **TOL)
    np.testing.assert_allclose(kv.v.numpy(), np.asarray(new["v"]), **TOL)
    assert int(new["pos"]) == pos + 1
    # the positions after pos take no part
    if pos < MAX_LEN - 1:
        kv.k[:, :, pos + 1:] = 100.0
        with torch.no_grad():
            again = tm(_t(x), torch.ones(B, 1, dtype=torch.bool), cache=kv,
                       pos=pos)
        torch.testing.assert_close(again, got)


def test_cross_attention_cache_and_beam_fold_match_jax(small):
    """Cross-attention reads the cached source keys and values: B rows of
    queries against JAX, then B * K = 9 query rows over the B-row cache
    (the beam fold) against JAX and against the same call over the source
    replicated K times."""
    jm, jv, _ = _mha(small)
    tm = small["model"].blocks[0].encoder_attn
    jv = {"params": small["params"]["block_0"]["encoder_attn"]}
    enc, mask = small["enc"], small["mask"]
    rng = np.random.RandomState(20)
    kv = tm.project_kv(_t(enc))
    jcache = {"k": jnp.asarray(kv.k.detach().numpy()),
              "v": jnp.asarray(kv.v.detach().numpy())}
    for rows in (B, 3 * B):
        x = rng.randn(rows, 1, 64).astype(np.float32)
        want, _ = jm.apply(jv, jnp.asarray(x), jnp.asarray(mask),
                           kv=jnp.asarray(enc), cache=jcache)
        with torch.no_grad():
            got = tm(_t(x), _t(mask), kv=_t(enc), cache=kv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rep = lambda a: np.repeat(a, 3, axis=0)  # noqa: E731
    with torch.no_grad():
        replicated = tm(_t(x), _t(rep(mask)), kv=_t(rep(enc)),
                        cache=tm.project_kv(_t(rep(enc))))
    torch.testing.assert_close(got, replicated, rtol=1e-6, atol=1e-6)


def test_decode_step_teacher_forced_matches_jax(small):
    """Four steps of given tokens: each step's logits and the cache after
    it against JAX's `_decode_step`; a cache from `init_cache`, without
    cross caches (the source projected at every step), gives the same
    logits."""
    jm, params, model = small["jm"], small["params"], small["model"]
    enc, mask = small["enc"], small["mask"]
    tokens = np.random.RandomState(30).randint(4, 500, (B, 4))
    jcache = jm.apply({"params": params}, jnp.asarray(enc), MAX_LEN,
                      method=jm.init_decode_cache)
    cache = model.init_decode_cache(_t(enc), MAX_LEN)
    bare = model.init_cache(B, MAX_LEN)
    for t in range(4):
        tok = tokens[:, t:t + 1]
        positions = np.full((B, 1), t)
        langs = np.zeros((B, 1), np.int64)
        want, jcache = jgen._decode_step(
            jm, params, jnp.asarray(tok, jnp.int32),
            jnp.asarray(positions, jnp.int32), jnp.asarray(langs, jnp.int32),
            jnp.asarray(enc), jnp.asarray(mask), jcache)
        with torch.no_grad():
            got = tgen._decode_step(model, _t(tok).long(), _t(positions),
                                    _t(langs), _t(enc), _t(mask), cache)
            again = tgen._decode_step(model, _t(tok).long(), _t(positions),
                                      _t(langs), _t(enc), _t(mask), bare)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        torch.testing.assert_close(again, got, rtol=1e-5, atol=1e-5)
        assert cache.pos == t + 1
        for i, layer in enumerate(cache.layers):
            jself = jcache[f"layer_{i}"]["self"]
            assert int(jself["pos"]) == t + 1
            np.testing.assert_allclose(layer.self_kv.k.numpy(),
                                       np.asarray(jself["k"]), **TOL)
            np.testing.assert_allclose(layer.self_kv.v.numpy(),
                                       np.asarray(jself["v"]), **TOL)


# ---------------------------------------------------------------------------
# greedy decoding
# ---------------------------------------------------------------------------


def _margins(model, src, mask, tokens, lang):
    """The top-2 logit margin of each step of ``tokens`` teacher-forced:
    where a token differs, how close the call was."""
    cache = model.init_decode_cache(src, tokens.shape[1])
    out = []
    with torch.no_grad():
        for t in range(tokens.shape[1] - 1):
            pos = torch.full((tokens.shape[0], 1), t)
            langs = None if lang is None else torch.full_like(pos, lang)
            logits = tgen._decode_step(model, tokens[:, t:t + 1], pos,
                                       langs, src, mask, cache)
            top2 = logits.topk(2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).tolist())
    return out


def _assert_tokens(got, want, model, src, mask, lang):
    toks, lens = got
    if not (np.array_equal(toks.numpy(), np.asarray(want[0]))
            and np.array_equal(lens.numpy(), np.asarray(want[1]))):
        raise AssertionError(
            f"tokens differ:\nport {toks.numpy()}\njax  {np.asarray(want[0])}"
            f"\nlengths {lens.tolist()} vs {np.asarray(want[1]).tolist()}"
            f"\ntop-2 margins by step of the port's tokens "
            f"{_margins(model, src, mask, toks, lang)}")


@pytest.mark.parametrize("eos,kw", [
    (False, dict(tgt_lang_id=0)),
    (False, dict(tgt_lang_id=None)),
    (False, dict(tgt_lang_id=0, start_index=EOS_IDX)),
    (True, dict(tgt_lang_id=0)),
])
def test_greedy_matches_jax(small, eos, kw):
    params, model = _models(small, eos)
    enc, mask = small["enc"], small["mask"]
    want = jgen.greedy_generate(small["jm"], params, jnp.asarray(enc),
                                jnp.asarray(mask), MAX_LEN, **kw)
    got = tgen.greedy_generate(model, _t(enc), _t(mask), MAX_LEN, **kw)
    _assert_tokens(got, want, model, _t(enc), _t(mask), kw["tgt_lang_id"])
    toks, lens = got
    assert (toks[:, 0] == kw.get("start_index", 0)).all()
    for row, n in zip(toks.tolist(), lens.tolist()):
        gen = row[1:]
        if EOS_IDX in gen:
            assert n == gen.index(EOS_IDX) + 2
            assert set(row[n:]) <= {PAD_IDX}
        else:
            assert n == MAX_LEN
    if eos:
        assert sorted(set(lens.tolist())) != [MAX_LEN]


def test_cached_greedy_equals_full_reencode(small):
    """Greedy with the cache equals a step-by-step argmax over a full
    causal re-encode without one (the twin of
    `tests/test_generation.py::test_greedy_matches_manual_argmax_decode`)."""
    model, enc, mask = small["eos_model"], _t(small["enc"]), _t(small["mask"])
    toks, _ = tgen.greedy_generate(model, enc, mask, MAX_LEN, tgt_lang_id=0)
    seq = torch.zeros((B, 1), dtype=torch.long)
    finished = torch.zeros(B, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(MAX_LEN - 1):
            hidden = model.encode_text(seq, torch.ones_like(seq, dtype=bool),
                                       torch.zeros_like(seq), causal=True,
                                       src_enc=enc, src_mask=mask)
            nxt = model.word_logits(hidden[:, -1]).argmax(-1)
            nxt = torch.where(finished, PAD_IDX, nxt)
            finished |= nxt == EOS_IDX
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    torch.testing.assert_close(toks, seq, rtol=0, atol=0)


def test_sampling_properties(small):
    """The same generator seed gives the same tokens, two seeds differ,
    and temperature 1e-4 gives the greedy tokens."""
    model, enc, mask = small["model"], _t(small["enc"]), _t(small["mask"])

    def sample(seed, temperature=1.5):
        gen = torch.Generator().manual_seed(seed)
        return tgen.greedy_generate(model, enc, mask, MAX_LEN, tgt_lang_id=0,
                                    temperature=temperature,
                                    generator=gen)[0]

    first = sample(0)
    assert torch.equal(first, sample(0))
    assert not torch.equal(first, sample(1))
    greedy = tgen.greedy_generate(model, enc, mask, MAX_LEN, tgt_lang_id=0)
    assert torch.equal(sample(0, 1e-4), greedy[0])


def test_flash_route_matches_jax_at_514_positions(small, monkeypatch):
    """Greedy at max_len 514: every step's self-attention over the 514
    cached positions goes through the port's flash route (the plain flash
    version on the CPU), JAX's through `mha_reference`; the tokens are
    equal."""
    params, model = _models(small, False)
    enc, mask = small["enc"][:2], small["mask"][:2]
    calls = []
    flash = ops.attention_flash

    def counted(q, k, *args):
        calls.append((tuple(q.shape), k.shape[1]))
        return flash(q, k, *args)

    monkeypatch.setattr(ops, "attention_flash", counted)
    want = jgen.greedy_generate(small["jm"], params, jnp.asarray(enc),
                                jnp.asarray(mask), 514, tgt_lang_id=0)
    got = tgen.greedy_generate(model, _t(enc), _t(mask), 514, tgt_lang_id=0)
    assert calls == [((2, 1, 64), 514)] * (2 * 513)
    monkeypatch.undo()
    _assert_tokens(got, want, model, _t(enc), _t(mask), 0)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beams,alpha,early,fast", [
    (1, 1.0, False, False),
    (1, 0.6, True, False),
    (3, 1.0, False, False),
    (3, 1.0, True, False),
    (3, 0.6, False, False),
    (3, 0.6, True, False),
    (3, 1.0, False, True),
])
def test_beam_search_matches_jax(small, beams, alpha, early, fast):
    params, model = _models(small, True)
    enc, mask = small["enc"], small["mask"]
    kw = dict(tgt_lang_id=0, length_penalty=alpha, early_stopping=early,
              fast_topk=fast)
    want = jgen.beam_search(small["jm"], params, jnp.asarray(enc),
                            jnp.asarray(mask), beams, MAX_LEN, **kw)
    got = tgen.beam_search(model, _t(enc), _t(mask), beams, MAX_LEN, **kw)
    _assert_tokens(got, want, model, _t(enc), _t(mask), 0)
    assert (got[1] >= 2).all() and (got[1] <= MAX_LEN).all()


def test_beam_rows_independent_and_permutation_equivariant(small):
    """The twin of `tests/test_generation.py::
    test_beam_rows_independent_and_permutation_equivariant`: with the
    beam-folded cross-attention a row's hypothesis does not depend on its
    place in the batch or on the other rows."""
    model, enc, mask = small["eos_model"], _t(small["enc"]), _t(small["mask"])
    kw = dict(beam_size=3, max_len=10, tgt_lang_id=0)
    toks, lens = tgen.beam_search(model, enc, mask, **kw)
    perm = torch.tensor([2, 0, 1])
    toks_p, lens_p = tgen.beam_search(model, enc[perm], mask[perm], **kw)
    assert torch.equal(toks_p, toks[perm]) and torch.equal(lens_p, lens[perm])
    toks_1, lens_1 = tgen.beam_search(model, enc[1:2], mask[1:2], **kw)
    assert torch.equal(toks_1[0], toks[1]) and int(lens_1[0]) == int(lens[1])


# ---------------------------------------------------------------------------
# the stable top-k, and the paths without a cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 6, 10])
def test_batched_top_k_orders_ties_as_jax(k):
    """Rows of bf16-rounded values (few distinct values, so ties at the
    k-th place), some rows all equal: values and indices equal
    `jax.lax.top_k`'s."""
    rng = np.random.RandomState(40 + k)
    x = rng.randint(-3, 4, (5, 7, 24)).astype(np.float32) * 0.1
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    x[1, 2] = 0.25
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = top_k(_t(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_paths_without_a_cache_are_unchanged(small):
    """`encode_text` (causal with a source), `encode_image` and
    `encode_joint` without a cache: bitwise the blocks' own no-cache loop,
    and the JAX package's outputs within TOL.  A decode with a cache in
    between changes nothing."""
    jm, params, model = small["jm"], small["params"], small["model"]
    rng = np.random.RandomState(50)
    tokens = rng.randint(4, 500, (B, 8))
    tmask = np.ones((B, 8), bool)
    tmask[2, 5:] = False
    feats = rng.randn(B, 8, 2048).astype(np.float32)
    locs = rng.rand(B, 8, 5).astype(np.float32)
    imask = np.ones((B, 8), bool)
    imask[0, 3:] = False
    enc, smask = small["enc"], small["mask"]
    v = {"params": params}
    with torch.no_grad():
        def run():
            return (model.encode_text(_t(tokens).long(), _t(tmask),
                                      causal=True, src_enc=_t(enc),
                                      src_mask=_t(smask)),
                    model.encode_image(_t(feats), _t(locs), _t(imask), True),
                    model.encode_joint(_t(tokens).long(), _t(tmask),
                                       _t(feats), _t(locs), _t(imask), True))

        got = run()
        x = model.embed_text(_t(tokens).long(), _t(tmask))
        for block in model.blocks:
            x = block(x, _t(tmask), True, src_enc=_t(enc),
                      src_mask=_t(smask))
        assert torch.equal(got[0], x)
        tgen.greedy_generate(model, _t(enc), _t(smask), 5)
        for a, b in zip(got, run()):
            assert torch.equal(a, b)
    want = (jm.apply(v, tokens, tmask, None, None, True, enc, smask,
                     method=jm.encode_text)[0],
            jm.apply(v, feats, locs, imask, None, True,
                     method=jm.encode_image),
            jm.apply(v, tokens, tmask, feats, locs, imask, True,
                     method=jm.encode_joint))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
