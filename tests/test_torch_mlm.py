"""The port's long-context xMLM step (m3p_tpu_torch.data.masking,
train.steps.mlm_loss, train.optim.FusedAdam, train.state) against the JAX
package on a small fp32 config at S = 520, just above the packed kernels'
512, so self-attention takes the flash path: `make_stream_batch`,
`mask_tokens` by its properties, `masked_ce`, `mlm_loss` and every gradient
leaf against `jax.value_and_grad` with the JAX masking fed to both sides,
`FusedAdam` against the JAX class over five updates, and three
`make_train_step` steps against the JAX step."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch import nn

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
from m3p_tpu_torch.data.masking import MaskingConfig, mask_tokens
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train.state import create_train_state
from m3p_tpu_torch.train.steps import make_train_step, masked_ce, mlm_loss

torch.set_num_threads(1)

S = 520          # above the packed kernels' 512: the flash path
N_WORDS = 512
MAX_PRED = 96
# fp32 on both sides; the two frameworks sum in other orders
TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL = 1e-4
# a key bias's gradient is zero up to rounding (see test_torch_train.py)
ZERO_GRAD_LEAF = "k_lin.bias"
ZERO_GRAD_RTOL = 1e-6


def _mask_cfg(cls=MaskingConfig, **kw):
    return cls(max_pred=MAX_PRED, n_words=N_WORDS, mask_index=N_WORDS - 1,
               **kw)


@pytest.fixture(scope="module")
def small():
    """2 layers, 64d, 4 heads, max_positions S + 2, its JAX model and
    parameters, and a B = 2 stream batch whose second row is 300 long."""
    jcfg = JaxModelConfig(
        n_words=N_WORDS, n_langs=3, emb_dim=64, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=8,
        refine_layers=1, mask_index=N_WORDS - 1, dtype="float32",
        max_positions=S + 2, use_pallas_attention=False)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    batch = jax_synthetic.make_stream_batch(np.random.RandomState(0), 2, S,
                                            N_WORDS)
    batch["lengths"][1] = 300
    return jcfg, jm, params, batch


def _port(jcfg, params, **changes):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = build_model(dataclasses.replace(cfg, **changes), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_masking(batch, key):
    """mask_tokens of the JAX package under the loss's own key split
    (`m3p_tpu/train/steps.py:162`), as torch tensors."""
    r_mask, _ = jax.random.split(key)
    tokens = jnp.asarray(batch["tokens"])
    text_mask = jax_lengths_to_mask(jnp.asarray(batch["lengths"]),
                                    tokens.shape[1])
    out = jax_masking.mask_tokens(r_mask, tokens, text_mask,
                                  _mask_cfg(jax_masking.MaskingConfig))
    return [torch.from_numpy(np.array(x)) for x in out]


def test_synthetic_stream_batch_is_the_jax_packages():
    want = jax_synthetic.make_stream_batch(np.random.RandomState(3), 8, 2048,
                                           250002)
    got = synthetic.make_stream_batch(np.random.RandomState(3), 8, 2048,
                                      250002)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def _draw(seed, b=16, s=400, lengths=None, cfg=None, mask_scores=None):
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(4, N_WORDS - 1, (b, s)))
    lengths = torch.full((b,), s) if lengths is None else lengths
    valid = torch.arange(s)[None, :] < lengths[:, None]
    tokens = torch.where(valid, tokens, 1)          # pads beyond the length
    gen = torch.Generator().manual_seed(seed)
    cfg = cfg or _mask_cfg()
    return tokens, valid, mask_tokens(gen, tokens, valid, cfg, mask_scores)


def test_mask_tokens_selection_rate_split_and_cap():
    tokens, valid, (masked, pos, labels, weights) = _draw(0)
    b, s = tokens.shape
    assert pos.shape == (b, MAX_PRED) and weights.dtype == torch.float32
    chosen = weights.sum().item()
    n_elig = b * (s - 1)
    sd = (n_elig * 0.15 * 0.85) ** 0.5
    assert abs(chosen - 0.15 * n_elig) < 5 * sd          # word_pred rate
    assert (weights.sum(1) <= MAX_PRED).all()
    assert torch.equal(labels, tokens.gather(1, pos))
    real = weights > 0
    rows = torch.arange(b)[:, None].expand_as(pos)
    # distinct slots per row; unchosen positions keep their token
    for r in range(b):
        assert len(set(pos[r][real[r]].tolist())) == int(real[r].sum())
    untouched = torch.ones_like(tokens, dtype=torch.bool)
    untouched[rows[real], pos[real]] = False
    assert torch.equal(masked[untouched], tokens[untouched])
    new = masked[rows[real], pos[real]]
    old = labels[real]
    is_mask = new == N_WORDS - 1
    kept = (new == old) & ~is_mask
    n = int(real.sum())
    for share, want in ((is_mask.float().mean(), 0.8),
                        (kept.float().mean(), 0.1)):
        assert abs(share.item() - want) < 5 * (want * (1 - want) / n) ** 0.5
    randoms = new[~is_mask & ~kept]
    assert randoms.numel() > 0
    assert (randoms >= 4).all() and (randoms < N_WORDS).all()


def test_mask_tokens_never_picks_bos_or_pads_and_caps_at_max_pred():
    lengths = torch.tensor([400, 37, 2, 1] * 4)
    tokens, valid, (_, pos, _, weights) = _draw(1, lengths=lengths)
    picked = pos[weights > 0]
    rows = torch.arange(16)[:, None].expand_as(pos)[weights > 0]
    assert (picked != 0).all()
    assert valid[rows, picked].all()
    assert (tokens[rows, picked] != 1).all()
    assert (weights[lengths == 1].sum() == 0).all()
    # a high rate fills every slot of a long row and no more
    _, _, (_, _, _, w) = _draw(2, cfg=_mask_cfg(word_pred=0.9))
    assert (w.sum(1) == MAX_PRED).all()
    # short sequences: P = min(max_pred, S)
    _, _, (_, p, _, _) = _draw(3, s=40)
    assert p.shape == (16, 40)


def test_mask_tokens_special_boundary_and_forced_slot():
    cfg = _mask_cfg(word_pred=0.0, mask_keep_rand=(0.0, 0.0, 1.0),
                    special_boundary=300)
    tokens, _, (masked, pos, labels, weights) = _draw(4, cfg=cfg)
    # nothing drawn in the whole batch: slot 0 of row 0 predicts position 1
    assert weights.sum().item() == 1.0 and weights[0, 0].item() == 1.0
    assert pos[0, 0].item() == 1 and labels[0, 0] == tokens[0, 1]
    assert 300 <= masked[0, 1].item() < N_WORDS
    assert torch.equal(masked[1:], tokens[1:])
    cfg = _mask_cfg(mask_keep_rand=(0.0, 0.0, 1.0), special_boundary=300)
    tokens, _, (masked, pos, _, weights) = _draw(5, cfg=cfg)
    new = masked.gather(1, pos)[weights > 0]
    assert (new >= 300).all() and (new < N_WORDS).all()


def test_mask_tokens_pos_prob_skews_the_selection():
    """mask_scores weight the draw: words scored 4x are chosen about 4x as
    often, with the expected total kept."""
    scores = torch.ones(N_WORDS)
    scores[:N_WORDS // 2] = 4.0
    tokens, _, (_, pos, labels, weights) = _draw(6, b=32,
                                                 mask_scores=scores)
    chosen = labels[weights > 0]
    heavy = (chosen < N_WORDS // 2).sum().item()
    light = (chosen >= N_WORDS // 2).sum().item()
    n_heavy = (tokens[:, 1:] < N_WORDS // 2).sum().item()
    n_light = tokens[:, 1:].numel() - n_heavy
    ratio = (heavy / n_heavy) / (light / n_light)
    assert 3.0 < ratio < 5.3, ratio
    total = weights.sum().item()
    n = tokens[:, 1:].numel()
    assert abs(total - 0.15 * n) < 5 * (n * 0.15 * 0.85) ** 0.5


def test_masked_ce_matches_jax():
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(3, 5, 40)).astype(np.float32)
    labels = rng.randint(-1, 40, (3, 5)).astype(np.int32)
    weights = (rng.rand(3, 5) > 0.3).astype(np.float32)
    for w in (weights, np.zeros_like(weights)):
        want = jax_steps.masked_ce(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(w))
        got = masked_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(w))
        np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_mlm_loss_and_every_gradient_leaf_match_jax(small):
    jcfg, jm, params, batch = small
    key = jax.random.PRNGKey(0)
    jcfg_mask = _mask_cfg(jax_masking.MaskingConfig)
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: jax_steps.mlm_loss(jm, p, jax.tree.map(jnp.asarray, batch),
                                     key, jcfg_mask, deterministic=True),
        has_aux=True)(params)
    model = _port(jcfg, params)
    loss, metrics = mlm_loss(model, _torch_batch(batch), None, _mask_cfg(),
                             deterministic=True,
                             masking=_jax_masking(batch, key))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    assert metrics["mlm"].item() == loss.item()
    want = grads_from_jax(jax.tree.map(np.asarray, want_grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    largest = max(w.abs().max().item() for w in want.values())
    reached = 0
    for name, w in want.items():
        g = got[name]
        if g is None:      # the image stream and the other heads
            assert not w.any(), name
            continue
        reached += 1
        if name.endswith(ZERO_GRAD_LEAF):
            for leaf in (g, w):
                assert leaf.abs().max().item() < ZERO_GRAD_RTOL * largest
            continue
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert err < GRAD_RTOL, (name, err)
    # embeddings (word table tied to the head), 2 blocks, the head bias
    assert reached >= 30


def test_mlm_loss_draws_its_masking_and_dropout_from_the_generators(small):
    jcfg, _, params, batch = small
    model = _port(jcfg, params, dropout=0.1)
    tb = _torch_batch(batch)

    def loss(seed, deterministic=False):
        with torch.no_grad():
            return mlm_loss(model, tb, Generators.from_seed(seed, "cpu"),
                            _mask_cfg(),
                            deterministic=deterministic)[0].item()

    assert loss(7) == loss(7) and loss(7) != loss(8)
    with pytest.raises(ValueError, match="generators"):
        mlm_loss(model, tb, None, _mask_cfg())


FUSED_CASES = [  # (spec suffix, gradient dtype)
    ("", torch.float32),
    (",mu_dtype=bfloat16,nu_dtype=bfloat16", torch.float32),
    (",master=1", torch.bfloat16),
    (",mu_dtype=bfloat16,nu_dtype=bfloat16,master=1", torch.bfloat16),
]


@pytest.mark.parametrize("suffix,grad_dtype", FUSED_CASES)
def test_fused_adam_on_fixed_gradients_matches_jax(suffix, grad_dtype):
    """Five updates with the clip active (the gradients' norm is above 1)
    against the JAX FusedAdam: the live parameters (bf16 under master=1),
    the fp32 master and the moments."""
    spec = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.01,"
            "warmup_updates=3,fused=1" + suffix)
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 2)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(5)]
    jdt = jnp.bfloat16 if grad_dtype == torch.bfloat16 else jnp.float32
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=1.0)
    jstate = jax_train_state(jax.tree.map(jnp.asarray, params), tx)
    module = nn.ParameterDict({n: nn.Parameter(torch.from_numpy(p.copy()))
                               for n, p in params.items()})
    ttx, _ = optim.build_optimizer(spec, clip_grad_norm=1.0)
    assert isinstance(ttx, optim.FusedAdam)
    state = create_train_state(module, ttx)
    assert {p.dtype for p in module.values()} == {grad_dtype}
    # the same fp32 arithmetic on both sides; bf16 moments and parameters
    # round the same values, and the clip's bf16 norm is optax's
    tol = dict(rtol=1e-5, atol=1e-7)
    for g in grads:
        jg = {n: jnp.asarray(x).astype(jdt) for n, x in g.items()}
        jstate = jstate.apply_gradients(grads=jg)
        for n, p in module.items():
            p.grad = torch.from_numpy(np.array(jg[n].astype(jnp.float32))
                                      ).to(grad_dtype)
        state.apply_gradients()
        names = list(module.keys())
        for n, p in module.items():
            np.testing.assert_allclose(p.detach().float().numpy(),
                                       np.asarray(jstate.params[n],
                                                  np.float32), **tol)
        for key in ("mu", "nu") + (("master",) if "master" in suffix
                                   else ()):
            for n, t in zip(names, state.opt_state[key]):
                want = np.asarray(jstate.opt_state[key][n], np.float32)
                low = key != "master" and "mu_dtype" in suffix
                assert t.dtype == (torch.bfloat16 if low else torch.float32)
                np.testing.assert_allclose(t.float().numpy(), want, **tol,
                                           err_msg=f"{key} {n}")
    assert state.step == int(jstate.step) == 5


def test_fused_adam_refuses_what_jax_refuses():
    for kw in ({"accumulate_gradients": 2}, {"guard_nonfinite": True},
               {"weight_decay": 0.1}):
        with pytest.raises(ValueError, match="fused=1"):
            optim.build_optimizer("adam,lr=0.1,fused=1", **kw)
    with pytest.raises(ValueError, match="adam variants"):
        optim.build_optimizer("sgd,lr=0.1,fused=1")


def test_three_train_steps_match_jax(small):
    """make_train_step over mlm_loss with the fused optimizer (fp32, clip
    5.0) against the JAX step: loss, gradient norm and every parameter
    after each of three steps; each step's masking is the JAX step's own
    (eps = 1e-3 for the reason test_torch_train.py gives)."""
    jcfg, jm, params, batch = small
    spec = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.001,"
            "warmup_updates=2,eps=0.001,fused=1")
    jcfg_mask = _mask_cfg(jax_masking.MaskingConfig)
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=5.0)
    jstate = jax_train_state(jax.tree.map(jnp.asarray, params), tx)
    jax_step = jax_steps.make_train_step(
        lambda p, b, key: jax_steps.mlm_loss(jm, p, b, key, jcfg_mask,
                                             deterministic=True),
        donate=False, with_grad_norm=True)
    model = _port(jcfg, params)
    ttx, _ = optim.build_optimizer(spec, clip_grad_norm=5.0)
    state = create_train_state(model, ttx)
    step = make_train_step(functools.partial(
        mlm_loss, mask_cfg=_mask_cfg(), deterministic=True),
        with_grad_norm=True)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = _torch_batch(batch)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        key = jax.random.PRNGKey(i)
        jstate, jmetrics = jax_step(jstate, jb, key)
        state, metrics = step(state, tb, None,
                              masking=_jax_masking(batch, key))
        assert state.step == int(jstate.step) == i + 1
        for name in ("mlm", "grad_norm"):
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
