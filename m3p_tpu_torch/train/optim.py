"""Optimizers of the port (counterpart of `m3p_tpu/train/optim.py`).

The reference string-spec surface (``"adam_inverse_sqrt,beta1=0.9,
beta2=0.98,lr=0.00005"``) and the non-fused optax chain of the JAX package
(`m3p_tpu/train/optim.py:252-301`), written out over torch tensors:

    MultiSteps(k)( [skip_nonfinite] -> [clip_by_global_norm] -> core )

with optax 0.2.6's semantics for each core:
* ``adam_inverse_sqrt`` / ``adam_cosine`` / ``adam`` (`Adam`): moments
  ``mu = b1 mu + (1 - b1) g`` and ``nu = b2 nu + (1 - b2) g^2``, bias
  correction with t = step + 1, ``eps`` outside the square root, the
  learning rate read at the pre-increment step count; ``weight_decay`` as
  ``optax.adamw`` (decoupled: ``lr * wd * p`` added to every parameter's
  update, no mask; ``adam_cosine`` ignores it, as the JAX package does);
  ``mu_dtype=bfloat16`` stores mu in bf16 (``nu_dtype`` and ``master`` are
  read by the fused branch only, and ignored here, as in the JAX chain);
* ``sgd`` (`SGD`, ``optax.sgd``: a momentum trace, 0 by default);
* ``adagrad`` (`Adagrad`: accumulator from 0.1, eps 1e-7 inside rsqrt);
* ``rmsprop`` (`RMSProp`: decay 0.9, eps 1e-8 inside rsqrt, scale from 0);
* ``accumulate_gradients = k`` (`MultiSteps`, ``optax.MultiSteps``): the
  running mean of k micro-steps' gradients, one update of the core on the
  k-th; the parameters and the core's state hold still on the others.
The step count lives on the host, so the schedule costs no device sync.

``fused=1`` builds `FusedAdam` (`m3p_tpu/train/optim.py:114-201`), the same
Adam update in one elementwise pass per parameter, with ``mu_dtype``/
``nu_dtype`` moment storage and, with ``master=1``, bf16 live parameters
over an fp32 master copy in the optimizer state; it takes no accumulation,
weight decay or guard, as in the JAX package.

Every optimizer's ``apply`` returns whether it updated the parameters.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch


def parse_optim_spec(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``"adam_inverse_sqrt,beta1=0.9,lr=0.0001"`` -> (name, kwargs).
    Non-numeric values (e.g. ``mu_dtype=bfloat16``) pass through as strings."""
    parts = spec.split(",")
    name = parts[0]
    kwargs: Dict[str, Any] = {}
    for p in parts[1:]:
        if not p:
            continue
        k, v = p.split("=")
        try:
            kwargs[k] = float(v)
        except ValueError:
            kwargs[k] = v
    return name, kwargs


def inverse_sqrt_schedule(lr: float, warmup_updates: int = 4000,
                          warmup_init_lr: float = 1e-7,
                          exp_factor: float = 0.5) -> Callable[[int], float]:
    """lr(t) = warmup_init + t*(lr-warmup_init)/W for t<W else
    lr * W^exp / t^exp, with t = max(step, 1)."""
    decay_factor = lr * warmup_updates ** exp_factor

    def schedule(step: int) -> float:
        step = max(int(step), 1)
        if step < warmup_updates:
            return warmup_init_lr + step * (lr - warmup_init_lr) / warmup_updates
        return decay_factor * step ** (-exp_factor)

    return schedule


def cosine_schedule(lr: float, warmup_updates: int = 4000,
                    warmup_init_lr: float = 1e-7, min_lr: float = 1e-9,
                    init_period: int = 1000000, period_mult: float = 1.0,
                    lr_shrink: float = 0.75) -> Callable[[int], float]:
    """Warmup then (optionally restarting) cosine decay; with the default
    period_mult=1 plain repeated cosine cycles."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_updates:
            return warmup_init_lr + step * (lr - warmup_init_lr) / warmup_updates
        t = step - warmup_updates
        if period_mult == 1.0:
            cycle = math.floor(t / init_period)
            t_cur = t - cycle * init_period
            period = float(init_period)
        else:
            cycle = math.floor(math.log1p(t / init_period * (period_mult - 1.0))
                               / math.log(period_mult))
            start = init_period * (period_mult ** cycle - 1.0) / (period_mult
                                                                  - 1.0)
            t_cur = t - start
            period = init_period * period_mult ** cycle
        shrink = lr_shrink ** cycle
        lo, hi = min_lr * shrink, lr * shrink
        return lo + 0.5 * (hi - lo) * (1.0 + math.cos(math.pi * t_cur / period))

    return schedule


def skip_nonfinite(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Zero every gradient when any is non-finite: the step is skipped
    instead of corrupting the moments (`m3p_tpu/train/optim.py:96-111`)."""
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    return [torch.where(finite, g, torch.zeros_like(g)) for g in grads]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all gradients, an fp32 device scalar."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def optax_global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm`` in the gradients' own dtype, rounding where it
    rounds: each leaf's squares in its dtype, their sum (taken in fp32)
    rounded back, the leaves' sums added one by one in that dtype, the
    square root in it.  With bf16 gradients this differs from the fp32 norm
    by up to a bf16 step, which the JAX `FusedAdam` clip inherits."""
    total = None
    for g in grads:
        leaf = (g * g).float().sum().to(g.dtype)
        total = leaf if total is None else total + leaf
    return torch.sqrt(total)


class _Chain:
    """[skip_nonfinite] -> [clip_by_global_norm(clip_norm)] -> the core
    update of a subclass (`_update`), as optax chains them."""

    def __init__(self, schedule: Callable[[int], float],
                 clip_norm: float = 0.0, guard_nonfinite: bool = False):
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.guard_nonfinite = guard_nonfinite

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: Dict[str, Any],
              step: int) -> bool:
        """Update ``params`` and ``state`` in place; ``step`` is the number
        of earlier updates.  Returns True (an update was made)."""
        grads = [g.float() for g in grads]
        if self.guard_nonfinite:
            grads = skip_nonfinite(grads)
        if self.clip_norm and self.clip_norm > 0:
            norm = global_norm(grads)
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        self._update(list(params), grads, state, step)
        return True

    def _update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                state: Dict[str, Any], step: int) -> None:
        raise NotImplementedError


class Adam(_Chain):
    """clip_by_global_norm(clip_norm) -> adam(schedule, b1, b2, eps), or
    ``optax.adamw`` with ``weight_decay``, as optax composes them;
    ``guard_nonfinite`` puts `skip_nonfinite` first.  ``mu_dtype`` (None =
    the parameter's) stores the first moment; as in optax, the step
    computes it in fp32 from ``b1`` (rounded to ``mu_dtype``) times the
    stored moment, and rounds it back after the update."""

    def __init__(self, schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 clip_norm: float = 0.0, guard_nonfinite: bool = False,
                 weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(schedule, clip_norm, guard_nonfinite)
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, step) -> None:
        mu, nu = state["mu"], state["nu"]
        b1, b2 = self.beta1, self.beta2
        if self.mu_dtype is None:
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            mu32 = mu
        else:
            b1_low = torch.tensor(b1, dtype=self.mu_dtype)
            mu32 = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu32, [(m * b1_low).float() for m in mu])
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        t = step + 1
        mu_hat = torch._foreach_div(mu32, 1.0 - b1 ** t)
        nu_hat = torch._foreach_div(nu, 1.0 - b2 ** t)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_add_(params, updates, alpha=-self.schedule(step))
        if mu32 is not mu:
            torch._foreach_copy_(mu, mu32)


class SGD(_Chain):
    """``optax.sgd(lr, momentum)``: a momentum trace ``m = g + momentum *
    m`` (kept at momentum 0 too, as optax keeps it) and ``p -= lr m``."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 clip_norm: float = 0.0, guard_nonfinite: bool = False):
        super().__init__(lambda step: lr, clip_norm, guard_nonfinite)
        self.momentum = momentum

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"trace": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, step) -> None:
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, trace, alpha=-self.schedule(step))


class Adagrad(_Chain):
    """``optax.adagrad(lr)``: a sum of squares from 0.1, the update
    ``g * rsqrt(sum + eps)`` with eps 1e-7."""

    def __init__(self, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, clip_norm: float = 0.0,
                 guard_nonfinite: bool = False):
        super().__init__(lambda step: lr, clip_norm, guard_nonfinite)
        self.initial = initial_accumulator_value
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"sum_of_squares": [torch.full_like(p, self.initial)
                                   for p in params]}

    def _update(self, params, grads, state, step) -> None:
        ss = state["sum_of_squares"]
        torch._foreach_addcmul_(ss, grads, grads)
        for p, g, s in zip(params, grads, ss):
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                              torch.zeros_like(s))
            p.add_(inv * g, alpha=-self.schedule(step))


class RMSProp(_Chain):
    """``optax.rmsprop(lr)``: ``nu = decay nu + (1 - decay) g^2`` from 0,
    the update ``g * rsqrt(nu + eps)`` (eps inside the root, as optax)."""

    def __init__(self, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 clip_norm: float = 0.0, guard_nonfinite: bool = False):
        super().__init__(lambda step: lr, clip_norm, guard_nonfinite)
        self.decay = decay
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"nu": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, step) -> None:
        nu = state["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.decay)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(params, scale, alpha=-self.schedule(step))


class MultiSteps:
    """``optax.MultiSteps(inner, k)``: every call adds the gradients to a
    running mean, ``acc += (g - acc) / (n + 1)`` after n earlier
    micro-steps of the window; the k-th call hands the mean to ``inner``
    once (clip and the core see it then) and clears it.  On the other calls
    the parameters and ``inner``'s state do not move, so ``step`` (the
    number of updates made) and the schedule advance once per k calls.

    The state holds ``inner``'s, the accumulation buffer ``acc`` (in the
    parameters' dtype) and ``mini_step``, the calls made in the window."""

    def __init__(self, inner: _Chain, every_k: int):
        if every_k < 1:
            raise ValueError(f"accumulate_gradients must be >= 1: {every_k}")
        self.inner = inner
        self.every_k = every_k

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"inner": self.inner.init(params),
                "acc": [torch.zeros_like(p) for p in params],
                "mini_step": 0}

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: Dict[str, Any],
              step: int) -> bool:
        """Accumulate ``grads``; on the k-th call of a window update
        ``params``.  Returns whether it did."""
        acc, n = state["acc"], state["mini_step"]
        delta = torch._foreach_sub([g.to(a.dtype) for g, a in
                                    zip(grads, acc)], acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(acc, delta)
        if n + 1 < self.every_k:
            state["mini_step"] = n + 1
            return False
        self.inner.apply(params, acc, state["inner"], step)
        torch._foreach_zero_(acc)
        state["mini_step"] = 0
        return True


class FusedAdam:
    """clip_by_global_norm(clip_norm) -> adam(schedule, b1, b2, eps) in one
    elementwise pass per parameter (`m3p_tpu/train/optim.py:114-201`):
    each leaf reads its gradient, moments and parameter (or fp32 master)
    once, computes in fp32, and writes them back, the moments rounded to
    ``mu_dtype``/``nu_dtype`` (None = the parameter's dtype).

    ``master=True``: `create_train_state` stores the live parameters in
    bf16 (``param_store_dtype``), the fp32 master sits in the state, and
    the update applies to the master and rounds it into the live
    parameter, as the JAX class does.  The clip's global norm and scale
    are taken in the gradients' dtype (bf16 under ``master``), as
    ``optax.global_norm`` takes them (`optax_global_norm`)."""

    def __init__(self, schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 clip_norm: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None,
                 master: bool = False):
        self.schedule = schedule
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.clip_norm = clip_norm
        self.mu_dtype = mu_dtype
        self.nu_dtype = nu_dtype
        self.master = master
        self.param_store_dtype = torch.bfloat16 if master else None

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        state = {
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in params],
            "nu": [torch.zeros_like(p, dtype=self.nu_dtype or p.dtype)
                   for p in params]}
        if self.master:
            state["master"] = [p.detach().float().clone() for p in params]
        return state

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: Dict[str, Any],
              step: int) -> bool:
        """Update ``params``, the moments and the master in place (the
        JAX ``fused_apply``); ``step`` is the number of earlier updates:
        the schedule reads it, bias correction uses t = step + 1.  Returns
        True (an update was made)."""
        b1, b2 = self.beta1, self.beta2
        t = step + 1
        g32 = [g.float() for g in grads]
        if self.clip_norm and self.clip_norm > 0:
            norm = optax_global_norm(grads)
            scale = torch.where(norm > self.clip_norm, self.clip_norm / norm,
                                torch.ones_like(norm))
            g32 = torch._foreach_mul(g32, scale.float())
        m32 = torch._foreach_mul([m.float() for m in state["mu"]], b1)
        torch._foreach_add_(m32, g32, alpha=1.0 - b1)
        v32 = torch._foreach_mul([v.float() for v in state["nu"]], b2)
        torch._foreach_addcmul_(v32, g32, g32, value=1.0 - b2)
        denom = torch._foreach_div(v32, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m32, 1.0 - b1 ** t)
        torch._foreach_mul_(upd, self.schedule(step))
        torch._foreach_div_(upd, denom)
        targets = state["master"] if self.master else list(params)
        torch._foreach_sub_(targets, [u.to(p.dtype)
                                      for u, p in zip(upd, targets)])
        torch._foreach_copy_(state["mu"], m32)
        torch._foreach_copy_(state["nu"], v32)
        if self.master:
            torch._foreach_copy_(list(params), targets)
        return True


Optimizer = Union[Adam, SGD, Adagrad, RMSProp, MultiSteps, FusedAdam]

_MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  "float32": None, None: None}


def _build_fused(name: str, kw: Dict[str, Any], lr: float, beta1: float,
                 beta2: float, eps: float, clip_grad_norm: float
                 ) -> Tuple[FusedAdam, Callable[[int], float]]:
    """The ``fused=1`` branch of `m3p_tpu/train/optim.py:229-250`."""
    if name == "adam_inverse_sqrt":
        schedule = inverse_sqrt_schedule(
            lr, warmup_updates=int(kw.pop("warmup_updates", 4000)),
            warmup_init_lr=kw.pop("warmup_init_lr", 1e-7),
            exp_factor=kw.pop("exp_factor", 0.5))
    elif name == "adam_cosine":
        schedule = cosine_schedule(
            lr, warmup_updates=int(kw.pop("warmup_updates", 4000)),
            warmup_init_lr=kw.pop("warmup_init_lr", 1e-7))
    elif name == "adam":
        schedule = lambda step: lr  # noqa: E731
    else:
        raise ValueError(f"fused=1 supports adam variants, not {name!r}")
    tx = FusedAdam(schedule, beta1=beta1, beta2=beta2, eps=eps,
                   clip_norm=clip_grad_norm,
                   mu_dtype=_MOMENT_DTYPES[kw.pop("mu_dtype", None)],
                   nu_dtype=_MOMENT_DTYPES[kw.pop("nu_dtype", None)],
                   master=bool(kw.pop("master", 0)))
    return tx, schedule


def build_optimizer(spec: str, clip_grad_norm: float = 0.0,
                    accumulate_gradients: int = 1, weight_decay: float = 0.0,
                    guard_nonfinite: bool = False
                    ) -> Tuple[Optimizer, Callable[[int], float]]:
    """The optimizer of a reference-style spec string and its learning-rate
    schedule (exposed for logging), as `m3p_tpu/train/optim.py:204-301`
    builds them."""
    name, kw = parse_optim_spec(spec)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    eps = kw.pop("eps", 1e-8)
    lr = kw.pop("lr", 1e-3)
    wd = kw.pop("weight_decay", weight_decay)
    if kw.pop("fused", 0):
        if accumulate_gradients > 1 or wd or guard_nonfinite:
            raise ValueError("fused=1 composes with plain adam only (no "
                             "accumulation, weight decay or guard)")
        return _build_fused(name, kw, lr, beta1, beta2, eps, clip_grad_norm)
    # the JAX chain reads mu_dtype only; nu_dtype is popped and dropped, and
    # master left unread (ROADMAP.md, section 3)
    mu_dtype = _MOMENT_DTYPES[kw.pop("mu_dtype", None)]
    kw.pop("nu_dtype", None)
    clip = dict(clip_norm=clip_grad_norm, guard_nonfinite=guard_nonfinite)
    adam = dict(beta1=beta1, beta2=beta2, eps=eps, mu_dtype=mu_dtype, **clip)
    if name == "adam_inverse_sqrt":
        schedule = inverse_sqrt_schedule(
            lr, warmup_updates=int(kw.pop("warmup_updates", 4000)),
            warmup_init_lr=kw.pop("warmup_init_lr", 1e-7),
            exp_factor=kw.pop("exp_factor", 0.5))
        tx = Adam(schedule, weight_decay=wd, **adam)
    elif name == "adam_cosine":
        schedule = cosine_schedule(
            lr, warmup_updates=int(kw.pop("warmup_updates", 4000)),
            warmup_init_lr=kw.pop("warmup_init_lr", 1e-7),
            min_lr=kw.pop("min_lr", 1e-9),
            init_period=int(kw.pop("init_period", 1000000)),
            period_mult=kw.pop("period_mult", 1.0),
            lr_shrink=kw.pop("lr_shrink", 0.75))
        # the JAX package builds optax.adam here: weight decay is ignored
        tx = Adam(schedule, **adam)
    elif name == "adam":
        schedule = lambda step: lr  # noqa: E731
        tx = Adam(schedule, weight_decay=wd, **adam)
    elif name == "sgd":
        tx = SGD(lr, momentum=kw.pop("momentum", 0.0), **clip)
        schedule = tx.schedule
    elif name == "adagrad":
        tx = Adagrad(lr, **clip)
        schedule = tx.schedule
    elif name == "rmsprop":
        tx = RMSProp(lr, **clip)
        schedule = tx.schedule
    else:
        raise ValueError(f"unknown optimizer: {name!r}")
    if accumulate_gradients > 1:
        tx = MultiSteps(tx, accumulate_gradients)
    return tx, schedule
