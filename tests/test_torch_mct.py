"""The port's MCT pre-training step (m3p_tpu_torch.data.masking.mask_regions,
data.synthetic.make_pretrain_batch, train.steps.mct_pretrain_loss and its
slot packing) against the JAX package on a small fp32 config: region
masking by its properties and, with the selection passed in, exactly; the
stable top_k against `jax.lax.top_k` with ties and overflow; the batch;
the loss with CLCM off and on and every gradient leaf against
`jax.value_and_grad`, with the JAX coin and maskings (drawn under the
loss's own key split) fed to the port; three `make_train_step` steps with
the fused optimizer against the JAX step.  deterministic=True wherever the
two are compared: the port draws other random numbers than JAX."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.data import masking as jax_masking
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model.transformer import lengths_to_mask as jax_lengths_to_mask
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train import steps as jax_steps
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch.checkpoint import grads_from_jax, params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data import synthetic
from m3p_tpu_torch.data.masking import MaskingConfig, mask_regions
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train.state import create_train_state
from m3p_tpu_torch.train.steps import (
    make_train_step, mct_pretrain_loss, top_k)

torch.set_num_threads(1)

N_WORDS = 512
GROUPS, SAMPLE_N, TEXT_LEN, REGIONS, CLCM_LEN = 2, 3, 12, 8, 16
MAX_PRED = 6
PACK_RATIO = 0.25            # bench.py's
# fp32 on both sides; the two frameworks sum in other orders
TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL = 1e-4
# a key bias's gradient is zero up to rounding (see test_torch_train.py)
ZERO_GRAD_LEAF = "k_lin.bias"
ZERO_GRAD_RTOL = 1e-6
LAMBDAS = dict(lambda_rel=1.0, lambda_mlm=1.0, lambda_mrm=0.5,
               lambda_mrfr=0.25, lambda_clcm=1.0)


def _mask_cfg(cls=MaskingConfig, **kw):
    kw = {"max_pred": MAX_PRED, **kw}
    return cls(n_words=N_WORDS, mask_index=N_WORDS - 1, **kw)


@pytest.fixture(scope="module")
def small():
    """2 layers, 64d, 4 heads, 1 refiner layer, 8 regions, its JAX model
    and parameters."""
    jcfg = JaxModelConfig(
        n_words=N_WORDS, n_langs=3, emb_dim=64, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
        refine_layers=1, mask_index=N_WORDS - 1, dtype="float32",
        use_pallas_attention=False)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, jm, jax.tree.map(np.asarray, params)


def _batch(with_clcm, with_raw):
    batch = jax_synthetic.make_pretrain_batch(
        np.random.RandomState(0), GROUPS, SAMPLE_N, TEXT_LEN, REGIONS,
        N_WORDS, with_clcm=with_clcm, clcm_len=CLCM_LEN)
    batch["img_len"][1] = 5                  # padded regions in one row
    if with_raw:
        batch["raw_feats"] = 2.0 * batch["feats"] + 0.5
    return batch


def _port(jcfg, params, **changes):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = build_model(dataclasses.replace(cfg, **changes), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_draws(batch, key):
    """The coin and both maskings of the JAX loss under its own key split
    (`m3p_tpu/train/steps.py:200-219`), as torch tensors."""
    r_coin, r_text, r_img, _ = jax.random.split(key, 4)
    tokens = jnp.asarray(batch["tokens"])
    bn, s = tokens.shape
    cfg = _mask_cfg(jax_masking.MaskingConfig)
    text_mask = jax_lengths_to_mask(jnp.asarray(batch["text_len"]), s)
    img_mask = jax_lengths_to_mask(jnp.asarray(batch["img_len"]), REGIONS)
    coin = jax.random.bernoulli(r_coin, 0.5, (bn,)).astype(jnp.float32)
    text = jax_masking.mask_tokens(r_text, tokens, text_mask, cfg)
    regions = jax_masking.mask_regions(r_img, jnp.asarray(batch["feats"]),
                                       jnp.asarray(batch["obj_labels"]),
                                       img_mask, cfg)

    def t(xs):
        return [torch.from_numpy(np.array(x)) for x in xs]

    return dict(coin=t([coin])[0], text_masking=t(text),
                region_masking=t(regions))


def _jax_loss(jm, **kw):
    return functools.partial(
        jax_steps.mct_pretrain_loss, jm, mask_cfg=_mask_cfg(
            jax_masking.MaskingConfig), sample_n=SAMPLE_N,
        deterministic=True, pack_ratio=PACK_RATIO, **LAMBDAS, **kw)


def test_synthetic_pretrain_batch_is_the_jax_packages():
    for kw in ({}, dict(with_clcm=True), dict(with_clcm=True, clcm_len=40)):
        want = jax_synthetic.make_pretrain_batch(np.random.RandomState(3), 5,
                                                 4, 64, 100, 250002, **kw)
        got = synthetic.make_pretrain_batch(np.random.RandomState(3), 5, 4,
                                            64, 100, 250002, **kw)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("case", ["ties", "overflow", "floats"])
def test_top_k_orders_ties_as_jax_lax_top_k(case):
    rng = np.random.RandomState(1)
    if case == "ties":        # few active slots: all survive, ties after
        w = (rng.rand(96) < 0.1).astype(np.float32)
        k = 24
    elif case == "overflow":  # more active slots than the budget
        w = (rng.rand(96) < 0.5).astype(np.float32)
        k = 24
        assert w.sum() > k
    else:
        w = rng.randint(0, 5, 200).astype(np.float32) / 4.0
        k = 77
    want_v, want_i = jax.lax.top_k(jnp.asarray(w), k)
    got_v, got_i = top_k(torch.from_numpy(w), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _region_draw(seed, b=64, r=100, lens=None, **cfg_kw):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(b, r, 16).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 1600, (b, r)).astype(np.int32))
    lens = torch.full((b,), r) if lens is None else lens
    img_mask = torch.arange(r)[None, :] < lens[:, None]
    cfg = _mask_cfg(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    return feats, labels, img_mask, mask_regions(gen, feats, labels,
                                                 img_mask, cfg)


def test_mask_regions_ratio_cap_and_padding():
    lens = torch.tensor([100, 40, 7, 0] * 16)
    feats, labels, img_mask, (masked, pos, lab, w, tgt) = _region_draw(
        0, lens=lens, max_pred=30)
    b = feats.shape[0]
    assert pos.shape == (b, 30) and w.dtype == torch.float32
    chosen = w.sum().item()
    n = int(img_mask.sum())
    assert abs(chosen - 0.15 * n) < 5 * (n * 0.15 * 0.85) ** 0.5
    rows = torch.arange(b)[:, None].expand_as(pos)
    real = w > 0
    assert img_mask[rows[real], pos[real]].all()        # padding never
    assert (w[lens == 0].sum() == 0).all()
    assert torch.equal(lab, labels.gather(1, pos))
    assert torch.equal(tgt, feats[rows, pos])
    # the chosen regions are zeroed, every other one is untouched
    zeroed = torch.zeros_like(img_mask)
    zeroed[rows[real], pos[real]] = True
    assert (masked[zeroed] == 0).all()
    assert torch.equal(masked[~zeroed], feats[~zeroed])
    # the cap: a high ratio fills every slot of a long row and no more
    *_, (_, _, _, w_hi, _) = _region_draw(1, obj_mask_ratio=0.9, max_pred=10)
    assert (w_hi.sum(1) == 10).all()
    # max_pred overrides the config's
    *_, (_, p_over, _, _, _) = _region_draw(2, max_pred=10)
    assert p_over.shape[1] == 10
    feats, labels, img_mask, _ = _region_draw(3)
    gen = torch.Generator().manual_seed(3)
    out = mask_regions(gen, feats, labels, img_mask, _mask_cfg(), max_pred=4)
    assert out[1].shape == (64, 4)


def test_mask_regions_with_the_jax_selection_is_exact():
    rng = np.random.RandomState(4)
    feats = rng.randn(6, REGIONS, 32).astype(np.float32)
    labels = rng.randint(0, 1600, (6, REGIONS)).astype(np.int32)
    img_mask = _np_mask([8, 5, 8, 1, 8, 3], REGIONS)
    cfg = _mask_cfg(jax_masking.MaskingConfig, obj_mask_ratio=0.4)
    want = jax_masking.mask_regions(jax.random.PRNGKey(5), jnp.asarray(feats),
                                    jnp.asarray(labels),
                                    jnp.asarray(img_mask), cfg)
    pos, w = (torch.from_numpy(np.array(want[i])) for i in (1, 3))
    got = mask_regions(None, torch.from_numpy(feats),
                       torch.from_numpy(labels), torch.from_numpy(img_mask),
                       _mask_cfg(), selection=(pos, w))
    assert w.sum() > 0
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def _np_mask(lens, s):
    return np.arange(s)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("with_clcm", [False, True])
def test_mct_loss_and_every_gradient_leaf_match_jax(small, with_clcm):
    """CLCM off (raw_feats absent: MRFR regresses the masked batch's
    features) and on (with raw_feats as the MRFR targets)."""
    jcfg, jm, params = small
    batch = _batch(with_clcm, with_raw=with_clcm)
    key = jax.random.PRNGKey(1)
    (want_loss, want_metrics), want_grads = jax.value_and_grad(
        lambda p: _jax_loss(jm)(p, jax.tree.map(jnp.asarray, batch), key),
        has_aux=True)(params)
    draws = _jax_draws(batch, key)
    assert 0 < draws["coin"].sum() < len(draws["coin"])
    model = _port(jcfg, params)
    loss, metrics = mct_pretrain_loss(
        model, _torch_batch(batch), None, _mask_cfg(), SAMPLE_N,
        deterministic=True, pack_ratio=PACK_RATIO, **LAMBDAS, **draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    names = {"rel", "mlm", "mrm", "mrfr", "loss"} | (
        {"clcm"} if with_clcm else set())
    assert set(metrics) == set(want_metrics) == names
    for name in names:
        np.testing.assert_allclose(metrics[name].item(),
                                   float(want_metrics[name]), **TOL,
                                   err_msg=name)
    want = grads_from_jax(jax.tree.map(np.asarray, want_grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    largest = max(w.abs().max().item() for w in want.values())
    reached = 0
    for name, w in want.items():
        g = got[name]
        if g is None:       # the language table, the decoder's attention
            assert not w.any(), name
            continue
        reached += 1
        if name.endswith(ZERO_GRAD_LEAF):
            for leaf in (g, w):
                assert leaf.abs().max().item() < ZERO_GRAD_RTOL * largest
            continue
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert err < GRAD_RTOL, (name, err)
    heads = [n for n in got if n.startswith(("obj_pred", "mrfr_head",
                                             "itm_pooler", "clcm_pooler"))
             and got[n] is not None]
    assert len(heads) == 12 + 4 * with_clcm
    assert reached >= 60


def test_mct_loss_draws_from_the_generators_and_takes_freelb_deltas(small):
    """The same seed gives the same loss, another seed another, no
    generators raise; zero freeLB deltas give the loss of no deltas, a
    nonzero image delta changes it."""
    jcfg, _, params = small
    model = _port(jcfg, params, dropout=0.1, use_fused_dropout=True)
    tb = _torch_batch(_batch(True, False))

    def loss(seed, **kw):
        with torch.no_grad():
            return mct_pretrain_loss(model, tb,
                                     Generators.from_seed(seed, "cpu"),
                                     _mask_cfg(), SAMPLE_N, **kw)[0].item()

    assert loss(7) == loss(7) and loss(7) != loss(8)
    with pytest.raises(ValueError, match="generators"):
        mct_pretrain_loss(model, tb, None, _mask_cfg(), SAMPLE_N)
    bn, s = tb["tokens"].shape
    zero_text = torch.zeros(bn, s, jcfg.emb_dim)
    zero_img = torch.zeros_like(tb["feats"])
    assert loss(7, text_delta=zero_text, img_delta=zero_img) == loss(7)
    img_delta = 0.5 * torch.ones_like(tb["feats"])
    assert loss(7, text_delta=zero_text, img_delta=img_delta) != loss(7)


def test_three_train_steps_match_jax(small):
    """make_train_step over mct_pretrain_loss with the fused optimizer
    (fp32, clip 5.0) against the JAX step, CLCM on: loss, gradient norm and
    every parameter after each of three steps, each step with the JAX
    step's own coin and maskings (eps = 1e-3 for the reason
    test_torch_train.py gives)."""
    jcfg, jm, params = small
    batch = _batch(True, False)
    spec = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.001,"
            "warmup_updates=2,eps=0.001,fused=1")
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=5.0)
    jstate = jax_train_state(jax.tree.map(jnp.asarray, params), tx)
    jloss = _jax_loss(jm)
    jax_step = jax_steps.make_train_step(
        lambda p, b, key: jloss(p, b, key), donate=False,
        with_grad_norm=True)
    model = _port(jcfg, params)
    ttx, _ = optim.build_optimizer(spec, clip_grad_norm=5.0)
    state = create_train_state(model, ttx)
    step = make_train_step(functools.partial(
        mct_pretrain_loss, mask_cfg=_mask_cfg(), sample_n=SAMPLE_N,
        deterministic=True, pack_ratio=PACK_RATIO, **LAMBDAS),
        with_grad_norm=True)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = _torch_batch(batch)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        jstate, jmetrics = jax_step(jstate, jb, key)
        state, metrics = step(state, tb, None, **_jax_draws(batch, key))
        assert state.step == int(jstate.step) == i + 1
        for name in ("loss", "clcm", "grad_norm"):
            np.testing.assert_allclose(metrics[name].item(),
                                       float(jmetrics[name]), rtol=1e-4)
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=f"{name} step {i}")
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > 1e-4
