"""Loss functions and the train step of the port (counterpart of
`m3p_tpu/train/steps.py`).

Ported objectives:
* ``itm``, the ITM retrieval fine-tune (the reference `t2i_step`/
  `i2t_step`): CE over each ``sample_n`` candidate grid plus a binary CE on
  every pair's score, over `M3PModel.encode_joint` in training mode, on
  batches shaped as `m3p_tpu_torch.data.synthetic.make_retrieval_batch`
  makes them;
* ``mlm``, xMLM on a text stream (the reference `mlm_step`): on-device
  80/10/10 masking into fixed slots, `M3PModel.encode_text`, the tied word
  head at the gathered slots and `masked_ce`, on batches shaped as
  `make_stream_batch` makes them.
Batches are dicts of tensors on the model's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from m3p_tpu_torch.data.masking import MaskingConfig, mask_tokens
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


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """Mean CE over the weighted slots, in fp32 (the reference's mean over
    masked positions; `m3p_tpu/train/steps.py:78-84`)."""
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.long().clamp_min(0).reshape(-1),
                         reduction="none").view(labels.shape)
    return (ce * weights).sum() / weights.sum().clamp_min(1.0)


def mlm_loss(model: M3PModel, batch: Batch, generator: Optional[Generators],
             mask_cfg: MaskingConfig, deterministic: bool = False,
             mask_scores: Optional[torch.Tensor] = None,
             masking: Optional[Sequence[torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Metrics]:
    """xMLM on a text stream (`m3p_tpu/train/steps.py:158-176`): mask the
    tokens, encode them, score the vocabulary at the masked slots only.

    ``masking`` = (masked tokens, positions, labels, weights) as
    `mask_tokens` returns them; when None they are drawn on the device from
    ``generator.device``.  Passing them in lets a caller hold the loss
    against another implementation's masks."""
    tokens = batch["tokens"].long()
    text_mask = lengths_to_mask(batch["lengths"], tokens.shape[1])
    if masking is None:
        if generator is None:
            raise ValueError("mlm_loss needs generators to draw its masking "
                             "(or the masking passed in)")
        masking = mask_tokens(generator.device, tokens, text_mask, mask_cfg,
                              mask_scores)
    masked, positions, labels, weights = masking
    hidden = model.encode_text(masked.long(), text_mask, batch.get("langs"),
                               deterministic=deterministic,
                               generator=generator)
    index = positions.long()[..., None].expand(-1, -1, hidden.shape[-1])
    logits = model.word_logits(hidden.gather(1, index))
    loss = masked_ce(logits, labels, weights)
    return loss, {"mlm": loss.detach()}


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
