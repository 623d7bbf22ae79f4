"""The port's ITM retrieval fine-tune step (m3p_tpu_torch.train) against the
JAX package on a small fp32 config: the loss and every gradient leaf of
`itm_finetune_loss`, `itm_grid_losses`, `expand_compact_batch`, the
learning-rate schedules, the optimizer on fixed gradients, and three steps
of `make_train_step`.  Dropout is off (deterministic=True) wherever the two
are compared: the port draws other random numbers than JAX.  At model level
dropout is checked by its properties."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train import steps as jax_steps
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch.checkpoint import grads_from_jax, params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data import synthetic
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train.state import create_train_state
from m3p_tpu_torch.train.steps import (
    expand_compact_batch, itm_finetune_loss, itm_grid_losses,
    make_train_step)

torch.set_num_threads(1)

# fp32 on both sides; the two frameworks sum in other orders
TOL = dict(rtol=1e-4, atol=1e-6)
# gradients: relative to the largest entry of each leaf (a leaf's small
# entries are differences of large terms through 2 blocks + 1 refiner layer)
GRAD_RTOL = 1e-4
# A key bias adds the same q.b to every score of a row, which the softmax
# ignores: its gradient is zero, and both frameworks return rounding noise
# (about 1e-8 against a largest gradient of about 1).  Such leaves are held
# to near zero, relative to the largest gradient of the model.
ZERO_GRAD_LEAF = "k_lin.bias"
ZERO_GRAD_RTOL = 1e-6
SAMPLE_N = 3
GROUPS = 2
TEXT_LEN = 12
REGIONS = 8


@pytest.fixture(scope="module")
def small():
    """The small config (2 layers, 64d, 4 heads, 1 refiner layer, 8
    regions), its JAX model and parameters, and a BN = 2 x 3 batch."""
    jcfg = JaxModelConfig(
        n_words=512, n_langs=3, emb_dim=64, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
        refine_layers=1, mask_index=511, dtype="float32",
        use_pallas_attention=False)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    batch = jax_synthetic.make_retrieval_batch(
        np.random.RandomState(0), GROUPS, SAMPLE_N, TEXT_LEN, REGIONS,
        jcfg.n_words)
    return jcfg, jm, params, batch


def _port(jcfg, params, **changes):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = build_model(dataclasses.replace(cfg, **changes), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_loss(jm, sample_n=SAMPLE_N):
    return functools.partial(jax_steps.itm_finetune_loss, jm,
                             sample_n=sample_n, deterministic=True)


def test_synthetic_retrieval_batch_is_the_jax_packages():
    want = jax_synthetic.make_retrieval_batch(np.random.RandomState(3), 4, 4,
                                              64, 100, 250002)
    got = synthetic.make_retrieval_batch(np.random.RandomState(3), 4, 4, 64,
                                         100, 250002)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_itm_grid_losses_match_jax():
    rng = np.random.RandomState(1)
    scores = (3 * rng.randn(5 * 4, 1)).astype(np.float32)
    labels = rng.randint(0, 4, (5,)).astype(np.int32)
    want = jax_steps.itm_grid_losses(jnp.asarray(scores), jnp.asarray(labels),
                                     4)
    got = itm_grid_losses(torch.from_numpy(scores), torch.from_numpy(labels),
                          4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), **TOL)


def test_expand_compact_batch_matches_jax():
    rng = np.random.RandomState(2)
    g, u, n, r = 3, 2, 4, 5
    batch = {
        "raw_feats": rng.randn(g, u, r, 2048).astype(np.float32),
        "locs": rng.rand(g, u, r, 5).astype(np.float32),
        "obj_labels": rng.randint(0, 1600, (g, u, r)).astype(np.int32),
        "img_len": rng.randint(1, r + 1, (g, u)).astype(np.int32),
        "img_index": rng.randint(0, u, (g, n)).astype(np.int32),
        "tokens": rng.randint(0, 50, (g * n, 7)).astype(np.int32),
    }
    batch["raw_feats"][0, 0, 0] = 0.0     # a zero feature row stays zero
    want = jax_steps.expand_compact_batch(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = expand_compact_batch(_torch_batch(batch))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL)
    dense = _torch_batch({"tokens": batch["tokens"]})
    assert expand_compact_batch(dense) is dense


def test_itm_finetune_loss_and_every_gradient_leaf_match_jax(small):
    jcfg, jm, params, batch = small
    (want_loss, want_metrics), want_grads = jax.value_and_grad(
        lambda p: _jax_loss(jm)(p, jax.tree.map(jnp.asarray, batch),
                                jax.random.PRNGKey(0)),
        has_aux=True)(params)
    model = _port(jcfg, params)
    loss, metrics = itm_finetune_loss(model, _torch_batch(batch), None,
                                      SAMPLE_N, deterministic=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for key in ("ce", "bce", "acc"):
        np.testing.assert_allclose(metrics[key].item(),
                                   float(want_metrics[key]), **TOL)
    want = grads_from_jax(jax.tree.map(np.asarray, want_grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    largest = max(w.abs().max().item() for w in want.values())
    reached = 0
    for name, w in want.items():
        g = got[name]
        if g is None:      # a head the loss does not reach
            assert not w.any(), name
            continue
        reached += 1
        assert g.shape == w.shape, name
        if name.endswith(ZERO_GRAD_LEAF):
            for leaf in (g, w):
                assert leaf.abs().max().item() < ZERO_GRAD_RTOL * largest
            continue
        scale = max(w.abs().max().item(), 1e-30)
        err = (g - w).abs().max().item() / scale
        assert err < GRAD_RTOL, (name, err)
    # encoder, refiner, embeddings and the ITM pooler all carry gradients
    assert reached >= 50


def test_dropout_is_seeded_and_changes_the_loss(small):
    jcfg, _, params, batch = small
    model = _port(jcfg, params, dropout=0.1, attention_dropout=0.1)
    tb = _torch_batch(batch)

    def loss(seed, deterministic=False):
        gen = None if deterministic else Generators.from_seed(seed, "cpu")
        with torch.no_grad():
            return itm_finetune_loss(model, tb, gen, SAMPLE_N,
                                     deterministic=deterministic)[0].item()

    assert loss(7) == loss(7)
    assert loss(7) != loss(8)
    assert loss(7) != loss(0, deterministic=True)
    # rate 0 in training mode is the deterministic forward
    plain = _port(jcfg, params)
    with torch.no_grad():
        a = itm_finetune_loss(plain, tb, Generators.from_seed(7, "cpu"),
                              SAMPLE_N)[0]
        b = itm_finetune_loss(plain, tb, None, SAMPLE_N,
                              deterministic=True)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generators"):
        itm_finetune_loss(model, tb, None, SAMPLE_N)


@pytest.mark.parametrize("spec", [
    "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005",
    "adam_inverse_sqrt,lr=0.001,warmup_updates=10,warmup_init_lr=0.0001,"
    "exp_factor=0.7",
    "adam_cosine,lr=0.001,warmup_updates=10,init_period=20,min_lr=0.00001",
    "adam_cosine,lr=0.001,warmup_updates=5,init_period=10,period_mult=2,"
    "lr_shrink=0.5",
    "adam,lr=0.0003",
])
def test_schedules_match_jax(spec):
    assert optim.parse_optim_spec(spec) == jax_optim.parse_optim_spec(spec)
    _, want = jax_optim.build_optimizer(spec)
    _, got = optim.build_optimizer(spec)
    for step in (0, 1, 2, 5, 9, 10, 11, 25, 60, 4000, 4001, 100000):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=1e-6)


@pytest.mark.parametrize("clip,guard", [(0.0, False), (0.5, True)])
def test_optimizer_on_fixed_gradients_matches_optax(clip, guard):
    """Five updates of fixed random gradients (one of them non-finite when
    the guard is on) against the optax chain of the JAX package."""
    spec = "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.01,warmup_updates=3"
    rng = np.random.RandomState(4)
    shapes = [(3, 4), (7,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    if guard:
        grads[2][1][3] = np.nan
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=clip,
                                      guard_nonfinite=guard)
    jp, jstate = [jnp.asarray(p) for p in params], None
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ttx, _ = optim.build_optimizer(spec, clip_grad_norm=clip,
                                   guard_nonfinite=guard)
    tstate = ttx.init(tp)
    for step, g in enumerate(grads):
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.apply(tp, [torch.from_numpy(x) for x in g], tstate, step)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-7)


def test_optimizer_refuses_what_the_port_lacks():
    """Every spec of the JAX package builds now (the specs themselves are
    held against optax in `tests/test_torch_optim_specs.py`); what is left
    to refuse is what the JAX package refuses too: fused=1 with
    accumulation, weight decay or the guard, a fused optimizer other than
    Adam, and an unknown name."""
    for spec, kw in [
            ("adam,lr=0.1,fused=1", {"accumulate_gradients": 2}),
            ("adam,lr=0.1,fused=1,weight_decay=0.01", {}),
            ("adam,lr=0.1,fused=1", {"guard_nonfinite": True}),
            ("sgd,lr=0.1,fused=1", {}),
            ("lamb,lr=0.1", {})]:
        with pytest.raises(ValueError):
            optim.build_optimizer(spec, **kw)


def test_three_train_steps_match_jax(small):
    """make_train_step + build_optimizer(clip_grad_norm=5.0) against the JAX
    step: the parameters after each of three steps.

    Adam's first update is lr * g / (|g| + eps): with eps = 1e-8 a gradient
    entry near zero (the key biases' are zero up to rounding) turns the two
    frameworks' rounding differences into differences of up to lr.  eps =
    1e-3 keeps the update smooth there, so the comparison sees the
    gradients and the optimizer, not the rounding."""
    jcfg, jm, params, batch = small
    spec = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.001,"
            "warmup_updates=2,eps=0.001")
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=5.0)
    jstate = jax_train_state(jax.tree.map(jnp.asarray, params), tx)
    jax_step = jax_steps.make_train_step(
        lambda p, b, key: _jax_loss(jm)(p, b, key), donate=False,
        with_grad_norm=True)
    model = _port(jcfg, params)
    ttx, _ = optim.build_optimizer(spec, clip_grad_norm=5.0)
    state = create_train_state(model, ttx)
    step = make_train_step(functools.partial(
        itm_finetune_loss, sample_n=SAMPLE_N, deterministic=True),
        with_grad_norm=True)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = _torch_batch(batch)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        jstate, jmetrics = jax_step(jstate, jb, jax.random.PRNGKey(i))
        state, metrics = step(state, tb, None)
        assert state.step == int(jstate.step) == i + 1
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[key].item(),
                                       float(jmetrics[key]), rtol=1e-4)
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=f"{name} step {i}")
    # the steps moved the model (the comparison is not of the start point)
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > 1e-4
