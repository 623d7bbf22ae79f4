"""Train state of the port (counterpart of `m3p_tpu/train/state.py`): the
model, its optimizer and the optimizer state, and the host-side count of
updates made so far.  The JAX state is an immutable pytree; here the model's
parameters and the moments are updated in place, which saves a copy of
each.  `Adam` (the optax chain) and `FusedAdam` (``fused=1``, the JAX
``fused_apply``) share one ``apply`` interface, so `apply_gradients` needs
no dispatch of its own."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Union

import torch
from torch import nn

from m3p_tpu_torch.train.optim import Adam, FusedAdam


@dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Union[Adam, FusedAdam]
    opt_state: Dict[str, Any]

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' ``.grad``; a parameter
        without one (a head the loss does not reach) takes a zero gradient,
        as its zero entry in the JAX gradient tree does."""
        params = list(self.model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        self.tx.apply(params, grads, self.opt_state, self.step)
        self.step += 1
        return self


def create_train_state(model: nn.Module,
                       tx: Union[Adam, FusedAdam]) -> TrainState:
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
