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
inner count of optax's schedule and Adam does.

Under data or sequence parallelism ``mesh`` is the `parallel.mesh.Mesh`
the gradients are averaged over (`sync_gradients`, before the clip), and
the losses' counts reduce over its batch shards
(`parallel.data_parallel.batch_reduction`).  Under parameter sharding
(`parallel.sharding.shard_model`) the model's parameters, and so their
gradients and the optimizer state made from them, are this rank's shards;
the guard and the global norm then take each leaf's sum over the ranks
(`leaf_sum`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from m3p_tpu_torch.train.optim import Optimizer, optax_global_norm


@dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer
    opt_state: Dict[str, Any]
    mesh: Optional[Any] = None

    def sync_gradients(self, metrics: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """Average every ``.grad`` and ``metrics`` over the ranks of
        ``mesh`` (one all-reduce); the identity on one rank."""
        if self.mesh is None or self.mesh.size == 1:
            return metrics
        from m3p_tpu_torch.parallel.data_parallel import average_over_ranks

        return average_over_ranks(self.mesh, self.model.parameters(),
                                  metrics)

    def leaf_sum(self):
        """None, or over sharded parameters the sum of each leaf's partial
        sums over the ranks (`parallel.sharding.replica_sum`), which the
        optimizer's guard and clip take."""
        from m3p_tpu_torch.parallel.sharding import replica_sum

        return replica_sum(list(self.model.parameters()))

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the parameters' gradients (missing ones are
        zeros) as `FusedAdam`'s clip takes it: `optax_global_norm` in the
        gradients' dtype, each leaf summed over its shards."""
        params = list(self.model.parameters())
        return optax_global_norm([p.grad if p.grad is not None
                                  else torch.zeros_like(p) for p in params],
                                 self.leaf_sum())

    def apply_gradients(self) -> "TrainState":
        """One micro-step of the optimizer from the parameters' ``.grad``
        (an update, unless a `MultiSteps` window is still filling); a
        parameter without one (a head the loss does not reach) takes a zero
        gradient, as its zero entry in the JAX gradient tree does."""
        params = list(self.model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.tx.apply(params, grads, self.opt_state, self.step,
                         self.leaf_sum()):
            self.step += 1
        return self


def create_train_state(model: nn.Module, tx: Optimizer,
                       mesh: Optional[Any] = None) -> TrainState:
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
    return TrainState(step=0, model=model, tx=tx, opt_state=opt_state,
                      mesh=mesh)
