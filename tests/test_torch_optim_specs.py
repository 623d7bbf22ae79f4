"""The optimizer specs of the port (m3p_tpu_torch.train.optim) against the
JAX package's optax chains (`m3p_tpu/train/optim.py:204-301`, optax 0.2.6):
weight decay (``optax.adamw``), gradient accumulation (``optax.MultiSteps``)
with clipping, the non-fused bf16 first moment, sgd with and without
momentum, adagrad and rmsprop.  Each runs five updates of fixed random
gradients on the same numpy parameters; the parameters are compared after
every micro-step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from m3p_tpu.train import optim as jax_optim
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

SHAPES = [(3, 4), (7,), (2, 2, 2)]
UPDATES = 5
# fp32 on both sides, the same operations in the same order up to XLA's
# fusion (an fma where torch rounds twice): a few ulps after five updates
TOL = dict(rtol=1e-5, atol=1e-7)


def _run(spec, clip=0.0, k=1, weight_decay=0.0, seed=4, big=False):
    """Five updates (5 k micro-steps) of the JAX chain and the port's on
    the same parameters and gradients; yields (micro-step, port params,
    JAX params, port update count) after each micro-step."""
    rng = np.random.RandomState(seed)
    scale = 10.0 if big else 1.0
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]
             for _ in range(UPDATES * k)]
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=clip,
                                      accumulate_gradients=k,
                                      weight_decay=weight_decay)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    model = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    ttx, _ = optim.build_optimizer(spec, clip_grad_norm=clip,
                                   accumulate_gradients=k,
                                   weight_decay=weight_decay)
    state = create_train_state(model, ttx)
    for i, g in enumerate(grads):
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(model, g):
            p.grad = torch.from_numpy(x)
        state.apply_gradients()
        yield i, [p.detach() for p in model], jp, state


def _check(spec, **kw):
    last = None
    for i, tp, jp, state in _run(spec, **kw):
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       err_msg=f"{spec} micro-step {i}",
                                       **TOL)
        last = state
    return last


@pytest.mark.parametrize("spec", [
    "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.01,warmup_updates=3,"
    "weight_decay=0.05",
    "adam,lr=0.003,weight_decay=0.1",
    # adam_cosine builds optax.adam: the decay is dropped, as in JAX
    "adam_cosine,lr=0.01,warmup_updates=2,init_period=4,weight_decay=0.1",
])
def test_weight_decay_matches_optax_adamw(spec):
    _check(spec, clip=1.0)


def test_adam_cosine_ignores_weight_decay_as_jax_does():
    spec = "adam_cosine,lr=0.01,warmup_updates=2,init_period=4"
    with_wd = [tp for _, tp, _, _ in _run(spec + ",weight_decay=0.5")][-1]
    without = [tp for _, tp, _, _ in _run(spec)][-1]
    for a, b in zip(with_wd, without):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [2, 4])
def test_accumulation_matches_optax_multisteps(k):
    """Running mean over k micro-steps, clip (at a norm the big gradients
    exceed) and Adam on the k-th; the parameters hold still bit for bit on
    the others, and the update count advances once per window."""
    spec = "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.01,warmup_updates=3"
    before = None
    for i, tp, jp, state in _run(spec, clip=1.0, k=k, big=True):
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       err_msg=f"micro-step {i}", **TOL)
        emitted = (i + 1) % k == 0
        assert state.step == (i + 1) // k
        assert state.opt_state["mini_step"] == (i + 1) % k
        if before is not None and not emitted:
            assert all(torch.equal(a, b) for a, b in zip(tp, before))
        if emitted:
            assert all(float(a.abs().max()) == 0.0
                       for a in state.opt_state["acc"])
        before = [t.clone() for t in tp]


def test_accumulation_with_weight_decay_and_cosine_schedule():
    _check("adam,lr=0.003,weight_decay=0.1", clip=0.5, k=2)
    _check("adam_cosine,lr=0.01,warmup_updates=2,init_period=4", k=3)


def test_non_fused_bf16_first_moment_matches_optax():
    """``mu_dtype=bfloat16`` without ``fused=1``: optax stores mu in bf16
    (b1 times the stored moment in bf16, the sum in fp32, rounded back
    after the update); ``nu_dtype`` and ``master`` are ignored, as the JAX
    chain ignores them."""
    spec = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.01,"
            "warmup_updates=3,mu_dtype=bfloat16")
    state = _check(spec, clip=1.0)
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state["mu"])
    assert all(n.dtype == torch.float32 for n in state.opt_state["nu"])
    ignored = _check(spec + ",nu_dtype=bfloat16,master=1", clip=1.0)
    assert all(n.dtype == torch.float32 for n in ignored.opt_state["nu"])
    assert "master" not in ignored.opt_state


@pytest.mark.parametrize("spec", [
    "sgd,lr=0.1", "sgd,lr=0.1,momentum=0.9", "adagrad,lr=0.1",
    "rmsprop,lr=0.01"])
def test_sgd_adagrad_rmsprop_match_optax(spec):
    _check(spec, clip=2.0)


def test_fused_keeps_refusing_accumulation_decay_and_guard():
    spec = "adam,lr=0.1,fused=1"
    for kw in ({"accumulate_gradients": 2}, {"weight_decay": 0.1},
               {"guard_nonfinite": True}):
        with pytest.raises(ValueError, match="fused=1"):
            optim.build_optimizer(spec, **kw)
    with pytest.raises(ValueError, match="fused=1"):
        optim.build_optimizer(spec + ",weight_decay=0.1")
