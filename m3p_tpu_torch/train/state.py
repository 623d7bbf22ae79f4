"""Train state of the port (counterpart of `m3p_tpu/train/state.py`): the
model, its optimizer and the optimizer state, and the host-side count of
updates made so far.  The JAX state is an immutable pytree; here the model's
parameters and the moments are updated in place, which saves a copy of
each."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from m3p_tpu_torch.train.optim import Adam


@dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Adam
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


def create_train_state(model: nn.Module, tx: Adam) -> TrainState:
    return TrainState(step=0, model=model, tx=tx,
                      opt_state=tx.init(list(model.parameters())))
