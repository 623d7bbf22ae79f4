"""Train state of the port (counterpart of `m3p_tpu/train/state.py`): the
model, its optimizer and the optimizer state, and the host-side count of
updates made so far.  The JAX state is an immutable pytree; here the model's
parameters and the optimizer state are updated in place, which saves a copy
of each.  Every optimizer of `train/optim.py` shares one ``apply``
interface, so `apply_gradients` needs no dispatch of its own.

Under ``accumulate_gradients = k`` the optimizer is a `MultiSteps`: its
state holds the accumulation buffer and the micro-step count of the window
(optax keeps both in ``opt_state``), so a checkpoint of the state holds
them, and ``step`` counts the updates made, one per k micro-steps, as the
inner count of optax's schedule and Adam does."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from m3p_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer
    opt_state: Dict[str, Any]

    def apply_gradients(self) -> "TrainState":
        """One micro-step of the optimizer from the parameters' ``.grad``
        (an update, unless a `MultiSteps` window is still filling); a
        parameter without one (a head the loss does not reach) takes a zero
        gradient, as its zero entry in the JAX gradient tree does."""
        params = list(self.model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.tx.apply(params, grads, self.opt_state, self.step):
            self.step += 1
        return self


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    """The state at step 0.  Under ``FusedAdam(master=True)`` the fp32
    master is taken first and the live parameters are then stored in the
    optimizer's ``param_store_dtype`` (bf16), so the GEMMs read bf16
    weights and the gradients come back in bf16
    (`m3p_tpu/train/state.py:36-46`)."""
    params = list(model.parameters())
    opt_state = tx.init(params)
    store = getattr(tx, "param_store_dtype", None)
    if store is not None:
        for p in params:
            p.data = p.data.to(store)
    return TrainState(step=0, model=model, tx=tx, opt_state=opt_state)
