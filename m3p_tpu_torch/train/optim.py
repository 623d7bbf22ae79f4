"""Optimizers of the port (counterpart of `m3p_tpu/train/optim.py`).

The reference string-spec surface (``"adam_inverse_sqrt,beta1=0.9,
beta2=0.98,lr=0.00005"``) and the non-fused optax chain of the JAX package
(`m3p_tpu/train/optim.py:252-301`), written out over torch tensors:

    [skip_nonfinite] -> [clip_by_global_norm] -> adam(schedule)

with optax's semantics: moments ``mu = b1 mu + (1 - b1) g`` and ``nu = b2 nu
+ (1 - b2) g^2``, bias correction with t = step + 1, ``eps`` outside the
square root, and the learning rate read at the pre-increment step count.
The step count lives on the host, so the schedule costs no device sync.

``fused=1`` builds `FusedAdam` (`m3p_tpu/train/optim.py:114-201`), the same
update in one elementwise pass per parameter, with ``mu_dtype``/
``nu_dtype`` moment storage and, with ``master=1``, bf16 live parameters
over an fp32 master copy in the optimizer state.

Not in the port yet (raise NotImplementedError): ``mu_dtype``/``nu_dtype``
without ``fused=1``, weight decay, gradient accumulation and the
sgd/adagrad/rmsprop specs.
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


class Adam:
    """clip_by_global_norm(clip_norm) -> adam(schedule, b1, b2, eps), as
    optax composes them; ``guard_nonfinite`` puts `skip_nonfinite` first."""

    def __init__(self, schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 clip_norm: float = 0.0, guard_nonfinite: bool = False):
        self.schedule = schedule
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.clip_norm = clip_norm
        self.guard_nonfinite = guard_nonfinite

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: Dict[str, Any],
              step: int) -> None:
        """Update ``params`` and the moments in ``state`` in place;
        ``step`` is the number of earlier updates."""
        grads = [g.float() for g in grads]
        if self.guard_nonfinite:
            grads = skip_nonfinite(grads)
        if self.clip_norm and self.clip_norm > 0:
            norm = global_norm(grads)
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        mu, nu = state["mu"], state["nu"]
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        t = step + 1
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
        nu_hat = torch._foreach_div(nu, 1.0 - b2 ** t)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(list(params), updates,
                            alpha=-self.schedule(step))


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
              step: int) -> None:
        """Update ``params``, the moments and the master in place (the
        JAX ``fused_apply``); ``step`` is the number of earlier updates:
        the schedule reads it, bias correction uses t = step + 1."""
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
                    ) -> Tuple[Union[Adam, FusedAdam], Callable[[int], float]]:
    """The optimizer of a reference-style spec string and its learning-rate
    schedule (exposed for logging)."""
    name, kw = parse_optim_spec(spec)
    beta1 = kw.pop("beta1", 0.9)
    beta2 = kw.pop("beta2", 0.999)
    eps = kw.pop("eps", 1e-8)
    lr = kw.pop("lr", 1e-3)
    if kw.pop("fused", 0):
        if accumulate_gradients > 1 or kw.get("weight_decay", weight_decay) \
                or guard_nonfinite:
            raise ValueError("fused=1 composes with plain adam only (no "
                             "accumulation, weight decay or guard)")
        return _build_fused(name, kw, lr, beta1, beta2, eps, clip_grad_norm)
    unported = [key for key in ("mu_dtype", "nu_dtype", "master") if key in kw]
    if kw.pop("weight_decay", weight_decay):
        unported.append("weight_decay")
    if accumulate_gradients > 1:
        unported.append("accumulate_gradients")
    if unported:
        raise NotImplementedError(
            f"the PyTorch port's optimizer does not support {unported} yet "
            f"(low-precision moments and the master copy need fused=1)")
    if name == "adam_inverse_sqrt":
        schedule = inverse_sqrt_schedule(
            lr, warmup_updates=int(kw.pop("warmup_updates", 4000)),
            warmup_init_lr=kw.pop("warmup_init_lr", 1e-7),
            exp_factor=kw.pop("exp_factor", 0.5))
    elif name == "adam_cosine":
        schedule = cosine_schedule(
            lr, warmup_updates=int(kw.pop("warmup_updates", 4000)),
            warmup_init_lr=kw.pop("warmup_init_lr", 1e-7),
            min_lr=kw.pop("min_lr", 1e-9),
            init_period=int(kw.pop("init_period", 1000000)),
            period_mult=kw.pop("period_mult", 1.0),
            lr_shrink=kw.pop("lr_shrink", 0.75))
    elif name == "adam":
        schedule = lambda step: lr  # noqa: E731
    elif name in ("sgd", "adagrad", "rmsprop"):
        raise NotImplementedError(f"the PyTorch port has no {name!r} "
                                  f"optimizer yet")
    else:
        raise ValueError(f"unknown optimizer: {name!r}")
    return Adam(schedule, beta1=beta1, beta2=beta2, eps=eps,
                clip_norm=clip_grad_norm,
                guard_nonfinite=guard_nonfinite), schedule
