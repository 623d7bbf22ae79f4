"""Loss functions and the train step of the port (counterpart of
`m3p_tpu/train/steps.py`).

This slice ports the ITM retrieval fine-tune objective (``itm``, the
reference `t2i_step`/`i2t_step`): CE over each ``sample_n`` candidate grid
plus a binary CE on every pair's score, over `M3PModel.encode_joint` in
training mode.  Batches are dicts of tensors on the model's device, shaped
as `m3p_tpu_torch.data.synthetic.make_retrieval_batch` makes them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.model.transformer import M3PModel, lengths_to_mask
from m3p_tpu_torch.train.optim import global_norm
from m3p_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def expand_compact_batch(batch: Batch) -> Batch:
    """Materialize grid rows from a compact image batch on the device.

    Compact batches ship each group's unique images once — ``raw_feats``
    (G, U, R, D), ``locs`` (G, U, R, 5), ``obj_labels`` (G, U, R),
    ``img_len`` (G, U) — and a local gather map ``img_index`` (G, n).  Rows
    are gathered per group and features L2-normalized here
    (`m3p_tpu/train/steps.py:46-75`).  Batches without ``img_index`` pass
    through unchanged."""
    if "img_index" not in batch:
        return batch
    batch = dict(batch)
    idx = batch.pop("img_index").long()               # (G, n) local slots
    g, n = idx.shape
    groups = torch.arange(g, device=idx.device)[:, None]

    def rows(pool):
        gathered = pool[groups, idx]                   # (G, n, ...)
        return gathered.reshape((g * n,) + tuple(gathered.shape[2:]))

    raw = rows(batch["raw_feats"])
    batch["raw_feats"] = raw
    norm = torch.linalg.vector_norm(raw.float(), dim=-1, keepdim=True)
    batch["feats"] = (raw / norm.clamp_min(1e-12)).to(raw.dtype)
    for k in ("locs", "obj_labels", "img_len"):
        if k in batch:
            batch[k] = rows(batch[k])
    return batch


def itm_grid_losses(scores: torch.Tensor, pos_labels: torch.Tensor,
                    sample_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B*N, 1) ITM scores -> (CE over the N-way grid, BCE vs one-hot), as
    `t2i_step` (`m3p_tpu/train/steps.py:87-98`)."""
    grid = scores.reshape(-1, sample_n).float()
    labels = pos_labels.long()
    ce = F.cross_entropy(grid, labels)
    one_hot = F.one_hot(labels, sample_n).float()
    bce = F.binary_cross_entropy_with_logits(grid, one_hot)
    return ce, bce


def itm_finetune_loss(model: M3PModel, batch: Batch,
                      generator: Optional[Generators], sample_n: int,
                      refine_image: bool = True, deterministic: bool = False,
                      multi_cls_weight: float = 1.0,
                      bin_cls_weight: float = 1.0
                      ) -> Tuple[torch.Tensor, Metrics]:
    """Fine-tune retrieval loss (`m3p_tpu/train/steps.py:321-342`): CE + BCE
    over the sample_n candidate grid.  Metrics stay on the device."""
    tokens = batch["tokens"].long()
    text_mask = lengths_to_mask(batch["text_len"], tokens.shape[1])
    img_mask = lengths_to_mask(batch["img_len"], batch["feats"].shape[1])
    hidden = model.encode_joint(tokens, text_mask, batch["feats"],
                                batch["locs"], img_mask, refine_image,
                                deterministic=deterministic,
                                generator=generator)
    scores = model.itm_score(hidden)
    ce, bce = itm_grid_losses(scores, batch["pos_label"], sample_n)
    loss = multi_cls_weight * ce + bin_cls_weight * bce
    grid = scores.detach().reshape(-1, sample_n)
    acc = (grid.argmax(dim=1) == batch["pos_label"].long()).float().mean()
    return loss, {"loss": loss.detach(), "ce": ce.detach(),
                  "bce": bce.detach(), "acc": acc}


def make_train_step(loss_fn: Callable[..., Tuple[torch.Tensor, Metrics]],
                    with_grad_norm: bool = False) -> Callable:
    """Wrap ``loss_fn(model, batch, generator, **kw)`` into a
    (state, batch, generator, **kw) -> (state, metrics) step: loss,
    backward, one optimizer update (`m3p_tpu/train/steps.py:504-538`).
    ``with_grad_norm`` adds the global gradient norm to the metrics.  The
    state is updated in place and returned; nothing waits for the device."""

    def step(state: TrainState, batch: Batch,
             generator: Optional[Generators], **kw
             ) -> Tuple[TrainState, Metrics]:
        batch = expand_compact_batch(batch)
        state.model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, batch, generator, **kw)
        loss.backward()
        metrics = dict(metrics)
        if with_grad_norm:
            metrics["grad_norm"] = global_norm(
                [p.grad for p in state.model.parameters()
                 if p.grad is not None])
        return state.apply_gradients(), metrics

    return step
