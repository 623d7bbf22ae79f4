"""The port's FreeLB steps (m3p_tpu_torch.train.freelb) against the JAX
package on a small fp32 config: `_init_delta`'s shape and bounds,
`_ascend` against the JAX function (both norms, projection on and off, a
zero gradient), and the three steps -- around the ITM fine-tune, the MCT
pre-training and the caption losses -- against the JAX steps at
``adv_steps=2, adv_max_norm=1e-2``, rate 0, with the JAX step's own
initial deltas (and, for MCT, its coin and maskings) passed to the port:
the mean loss and every parameter after one Adam step.  Then the MCT step
with dropout 0.1 on the CPU: its passes replay one coin, masking and set
of dropout masks."""

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
from m3p_tpu.train import freelb as jax_freelb
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data.masking import MaskingConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.train import freelb, optim
from m3p_tpu_torch.train.state import create_train_state
from m3p_tpu_torch.train.steps import mct_pretrain_loss

torch.set_num_threads(1)

N_WORDS = 512
GROUPS, SAMPLE_N, TEXT_LEN, REGIONS = 2, 3, 12, 8
MAX_PRED = 6
ADV = dict(adv_steps=2, adv_max_norm=1e-2)
# test_torch_decoder.py's optimizer (eps = 1e-3 for the reason
# test_torch_train.py gives); the parameters after one step at the
# tolerance of test_torch_mct.py::test_three_train_steps_match_jax
SPEC = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.001,"
        "warmup_updates=2,eps=0.001")
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)


def _mask_cfg(cls=MaskingConfig):
    return cls(n_words=N_WORDS, mask_index=N_WORDS - 1, max_pred=MAX_PRED)


@pytest.fixture(scope="module")
def small():
    """2 layers, 64d, 4 heads, 1 refiner layer, 8 regions: the JAX model
    and its parameters."""
    jcfg = JaxModelConfig(
        n_words=N_WORDS, n_langs=3, emb_dim=64, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
        refine_layers=1, mask_index=N_WORDS - 1, dtype="float32",
        use_pallas_attention=False)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, jm, jax.tree.map(np.asarray, params)


def _port(jcfg, params, **changes):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = build_model(dataclasses.replace(cfg, **changes), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the delta arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["l2", "linf"])
def test_init_delta_shape_and_bounds(norm_type):
    lengths = torch.tensor([12, 5, 1, 7])
    gen = torch.Generator().manual_seed(0)
    d = freelb._init_delta(gen, (4, 12, 64), lengths, 64, 1e-4, norm_type)
    assert d.shape == (4, 12, 64) and d.dtype == torch.float32
    if norm_type == "linf":
        bound = torch.full((4, 1, 1), 1e-4)
    else:
        bound = 1e-4 / torch.sqrt(lengths.float() * 64).reshape(-1, 1, 1)
    assert (d.abs() <= bound).all()
    # U(-bound, bound): both signs, and most of the range reached
    assert (d > 0).any() and (d < 0).any()
    assert ((d.abs() / bound).amax(dim=(1, 2)) > 0.9).all()
    again = freelb._init_delta(torch.Generator().manual_seed(0), (4, 12, 64),
                               lengths, 64, 1e-4, norm_type)
    assert torch.equal(d, again)


@pytest.mark.parametrize("zero_grad", [False, True])
@pytest.mark.parametrize("max_norm", [0.0, 1e-2])
@pytest.mark.parametrize("norm_type", ["l2", "linf"])
def test_ascend_matches_jax(norm_type, max_norm, zero_grad):
    rng = np.random.RandomState(1)
    delta = (0.01 * rng.randn(3, 5, 16)).astype(np.float32)
    grad = rng.randn(3, 5, 16).astype(np.float32)
    grad[1] *= 1e-6              # a small row
    if zero_grad:
        grad[2] = 0.0            # the 1e-8 floor
    lr = 5e-3
    want = jax_freelb._ascend(jnp.asarray(delta), jnp.asarray(grad), lr,
                              max_norm, norm_type)
    got = freelb._ascend(_t(delta), _t(grad), lr, max_norm, norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    if max_norm:                 # the projection bites on some row
        free = freelb._ascend(_t(delta), _t(grad), lr, 0.0, norm_type)
        assert not torch.equal(free, got)


# ---------------------------------------------------------------------------
# the three steps against the JAX steps
# ---------------------------------------------------------------------------


def _deltas(rng, text_shape, text_len, feats, feats_dtype=None):
    """The JAX steps' initial deltas under their key split."""
    k_init, k_img, k_rest = jax.random.split(rng, 3)
    adv = jax_freelb.FreeLBConfig(**ADV)
    d_text = jax_freelb._init_delta(k_init, text_shape,
                                    jnp.asarray(text_len), text_shape[-1],
                                    adv.adv_init_mag, adv.norm_type)
    d_img = jax_freelb._init_delta(
        k_img, feats.shape, jnp.ones((feats.shape[0],), jnp.int32),
        feats.shape[-1], adv.adv_init_mag, adv.norm_type)
    if feats_dtype is not None:
        d_img = d_img.astype(feats_dtype)
    return (_t(d_text), _t(d_img)), k_rest


def _mct_draws(batch, key):
    """The coin and maskings of the JAX loss under its own key split."""
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
    return dict(coin=_t(coin), text_masking=[_t(x) for x in text],
                region_masking=[_t(x) for x in regions])


def _itm_case(jm, batch, rng):
    jax_step = jax_freelb.make_freelb_itm_step(
        jm, SAMPLE_N, jax_freelb.FreeLBConfig(**ADV), donate=False)
    bn, s = batch["tokens"].shape
    deltas, _ = _deltas(rng, (bn, s, 64), batch["text_len"], batch["feats"],
                        batch["feats"].dtype)
    return jax_step, functools.partial(
        freelb.make_freelb_itm_step, sample_n=SAMPLE_N), dict(deltas=deltas)


def _mct_case(jm, batch, rng):
    jax_step = jax_freelb.make_freelb_pretrain_step(
        jm, SAMPLE_N, _mask_cfg(jax_masking.MaskingConfig),
        jax_freelb.FreeLBConfig(**ADV), donate=False)
    bn, s = batch["tokens"].shape
    deltas, k_loss = _deltas(rng, (bn, s, 64), batch["text_len"],
                             batch["feats"])
    return jax_step, functools.partial(
        freelb.make_freelb_pretrain_step, sample_n=SAMPLE_N,
        mask_cfg=_mask_cfg()), dict(deltas=deltas, deterministic=True,
                                    **_mct_draws(batch, k_loss))


def _ic_case(jm, batch, rng):
    jax_step = jax_freelb.make_freelb_ic_step(
        jm, jax_freelb.FreeLBConfig(**ADV), donate=False)
    b, t = batch["tokens"].shape
    deltas, _ = _deltas(rng, (b, t - 1, 64),
                        np.maximum(batch["tgt_len"] - 1, 1), batch["feats"])
    return jax_step, freelb.make_freelb_ic_step, dict(deltas=deltas)


def _batch(kind):
    rng = np.random.RandomState(0)
    if kind == "itm":
        batch = jax_synthetic.make_retrieval_batch(rng, GROUPS, SAMPLE_N,
                                                   TEXT_LEN, REGIONS,
                                                   N_WORDS)
    elif kind == "mct":
        batch = jax_synthetic.make_pretrain_batch(rng, GROUPS, SAMPLE_N,
                                                  TEXT_LEN, REGIONS, N_WORDS)
    else:
        batch = jax_synthetic.make_caption_batch(rng, 3, 16, REGIONS,
                                                 N_WORDS)
    batch["img_len"][1] = 5                  # padded regions in one row
    return batch


CASES = {"itm": _itm_case, "mct": _mct_case, "ic": _ic_case}


@pytest.mark.parametrize("kind", list(CASES))
def test_freelb_step_matches_jax(small, kind):
    """One step: the mean loss over the K = 2 passes, then every parameter
    after the Adam update of the accumulated gradients.  In the ITM step
    the word table takes no gradient (its embeddings are taken outside
    the differentiated passes) and does not move."""
    jcfg, jm, params = small
    batch = _batch(kind)
    rng = jax.random.PRNGKey(3)
    jax_step, make_port_step, step_kw = CASES[kind](jm, batch, rng)
    tx, _ = jax_optim.build_optimizer(SPEC, clip_grad_norm=5.0)
    jstate = jax_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstate, jmetrics = jax_step(jstate, jax.tree.map(jnp.asarray, batch),
                                rng)
    model = _port(jcfg, params)
    ttx, _ = optim.build_optimizer(SPEC, clip_grad_norm=5.0)
    state = create_train_state(model, ttx)
    step = make_port_step(model, adv=freelb.FreeLBConfig(**ADV))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = step(state, {k: _t(v) for k, v in batch.items()}, None,
                          **step_kw)
    assert state.step == int(jstate.step) == 1
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=1e-4, err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **PARAM_TOL, err_msg=name)
    word = "text_emb.word.weight"
    moved = (model.text_emb.word.weight.detach() - start[word]).abs().max()
    if kind == "itm":
        assert model.text_emb.word.weight.grad is None
        assert moved == 0
        np.testing.assert_array_equal(want[word].numpy(),
                                      start[word].numpy())
    else:
        assert moved > 1e-4
    assert max((p.detach() - start[n]).abs().max().item()
               for n, p in model.named_parameters()) > 1e-4


def test_freelb_deltas_move_the_loss(small):
    """The passes differ: the second pass sees the ascended deltas (an
    adv_lr large enough to show in the loss), and a step without
    generators or deltas raises."""
    jcfg, _, params = small
    model = _port(jcfg, params)
    batch = {k: _t(v) for k, v in _batch("ic").items()}
    b, t = batch["tokens"].shape
    deltas = (torch.zeros(b, t - 1, 64), torch.zeros_like(batch["feats"]))

    def mean_loss(adv_lr):
        state = create_train_state(model, optim.build_optimizer(
            "adam,lr=0.0")[0])
        step = freelb.make_freelb_ic_step(model, freelb.FreeLBConfig(
            adv_steps=2, adv_lr=adv_lr, adv_max_norm=0.0))
        return step(state, batch, None, deltas=deltas)[1]["loss"].item()

    assert mean_loss(1.0) > mean_loss(0.0)
    with pytest.raises(ValueError, match="generators"):
        freelb.make_freelb_ic_step(model, freelb.FreeLBConfig())(
            create_train_state(model, optim.build_optimizer("adam")[0]),
            batch, None)


def test_pretrain_passes_replay_one_draw_under_dropout(small, monkeypatch):
    """Dropout and attention dropout 0.1 with the fused residual path, the
    generators drawing the initial deltas, the coin and the maskings: with
    adv_lr = 0 every pass gives the same loss, and the accumulated
    gradient is that of one pass from the same generator state; the next
    step draws anew."""
    jcfg, _, params = small
    model = _port(jcfg, params, dropout=0.1, attention_dropout=0.1,
                  use_fused_dropout=True)
    reference = _port(jcfg, params, dropout=0.1, attention_dropout=0.1,
                      use_fused_dropout=True)
    batch = {k: _t(v) for k, v in _batch("mct").items()}
    losses = []

    def recorded(*args, **kw):
        out = mct_pretrain_loss(*args, **kw)
        losses.append(out[0].item())
        return out

    monkeypatch.setattr(freelb, "mct_pretrain_loss", recorded)
    gens = Generators.from_seed(5, "cpu")
    adv = freelb.FreeLBConfig(adv_steps=3, adv_lr=0.0)
    step = freelb.make_freelb_pretrain_step(model, SAMPLE_N, _mask_cfg(),
                                            adv)
    state = create_train_state(model, optim.build_optimizer(
        "adam,lr=0.0")[0])
    # the deltas the step draws first, then the generators' state after
    probe = Generators.from_seed(5, "cpu")
    bn, s = batch["tokens"].shape
    d_text = freelb._init_delta(probe.device, (bn, s, 64),
                                batch["text_len"], 64, adv.adv_init_mag,
                                adv.norm_type)
    d_img = freelb._init_delta(probe.device, batch["feats"].shape,
                               torch.ones(bn), 2048, adv.adv_init_mag,
                               adv.norm_type)
    state, metrics = step(state, batch, gens)
    assert len(losses) == 3 and losses[0] == losses[1] == losses[2]
    np.testing.assert_allclose(metrics["loss"].item(), losses[0], rtol=1e-6)
    loss, _ = mct_pretrain_loss(reference, batch, probe, _mask_cfg(),
                                SAMPLE_N, text_delta=d_text, img_delta=d_img)
    loss.backward()
    assert loss.item() == losses[0]
    reached = 0
    for (name, p), q in zip(model.named_parameters(),
                            reference.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            reached += 1
            torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-8,
                                       msg=name)
    assert reached >= 60
    state, _ = step(state, batch, gens)
    assert len(losses) == 6 and losses[3] == losses[5] != losses[0]
