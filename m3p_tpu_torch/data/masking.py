"""On-device word and region masking for the MLM and MRM objectives
(counterpart of `m3p_tpu/data/masking.py:28-155`: `MaskingConfig`,
`_select_fixed`, `mask_tokens`, `mask_regions`).

The 80/10/10 masking of the reference with a fixed number of prediction
slots per sequence (``max_pred``) and a weight per slot marking the real
ones, drawn on the tokens' device from a ``torch.Generator``.  The draws
follow the JAX rules one for one (Bernoulli selection over eligible
positions, a random priority ranking the selected ones first, ``top_k``
packing, the force-one-slot fallback), but from torch's generator, so the
masks differ from the JAX package's: the tests compare properties, and
compare losses with the JAX masking fed to both sides.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MaskingConfig:
    word_pred: float = 0.15          # fraction of tokens to predict
    mask_keep_rand: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    obj_mask_ratio: float = 0.15
    max_pred: int = 24               # fixed masked slots per sequence
    n_words: int = 250002
    mask_index: int = 250001
    pad_index: int = 1
    special_boundary: int = 4        # ids < this are never drawn as randoms


def _select_fixed(generator: torch.Generator, eligible: torch.Tensor,
                  rate: float, max_pred: int,
                  pos_prob: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli(rate) over eligible (B, S) positions, capped at
    ``max_pred`` per row and packed into fixed slots.

    ``pos_prob`` (B, S) skews the draw: position i is selected with
    probability ``rate * pos_prob[i] * n_eligible / sum(pos_prob over
    eligible)`` (sums over the whole batch), clipped to [0, 1].

    Returns (positions (B, P) int64, weights (B, P) float32) with P =
    min(max_pred, S)."""
    b, s = eligible.shape
    max_pred = min(max_pred, s)
    dev = eligible.device
    if pos_prob is None:
        p = rate
    else:
        w = torch.where(eligible, pos_prob.float(), 0.0)
        n_elig = eligible.sum()
        p = (rate * w * n_elig / w.sum().clamp_min(1e-9)).clamp(0.0, 1.0)
    selected = (torch.rand((b, s), generator=generator, device=dev) < p) \
        & eligible
    # selected positions first, in the order of a random priority
    prio = torch.rand((b, s), generator=generator, device=dev)
    score = torch.where(selected, 1.0 + prio, prio * 1e-3)
    top, positions = torch.topk(score, max_pred, dim=1)
    return positions, (top >= 1.0).float()


def mask_tokens(generator: torch.Generator, tokens: torch.Tensor,
                valid_mask: torch.Tensor, cfg: MaskingConfig,
                mask_scores: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
    """80/10/10 MLM masking with fixed prediction slots.

    tokens (B, S) and valid_mask (B, S) bool -> (masked tokens (B, S),
    positions (B, P), labels (B, P), weights (B, P)).  Position 0 (BOS) and
    pads are never chosen; a random replacement is drawn from
    [special_boundary, n_words).  ``mask_scores`` (n_words,) skews the
    selection toward the words it scores higher (the reference's
    ``sample_alpha``).  When nothing in the whole batch is selected, slot 0
    of row 0 predicts position 1 (the reference's ``pred_mask[0, 0] = 1``
    fallback), decided on the device without a sync."""
    b, s = tokens.shape
    dev = tokens.device
    eligible = valid_mask.bool() & (tokens != cfg.pad_index)
    eligible[:, 0] = False
    pos_prob = None
    if mask_scores is not None:
        pos_prob = mask_scores[tokens.long().clamp(0,
                                                   mask_scores.shape[0] - 1)]
    positions, weights = _select_fixed(generator, eligible, cfg.word_pred,
                                       cfg.max_pred, pos_prob)
    n_pred = positions.shape[1]
    first = ((torch.arange(b, device=dev) == 0)[:, None]
             & (torch.arange(n_pred, device=dev) == 0)[None, :])
    force = first & (weights.sum() == 0)
    positions = torch.where(force, 1, positions)
    weights = torch.where(force, 1.0, weights)
    labels = tokens.gather(1, positions)

    p_mask, _, p_rand = cfg.mask_keep_rand
    u = torch.rand((b, n_pred), generator=generator, device=dev)
    rand_words = torch.randint(cfg.special_boundary, cfg.n_words,
                               (b, n_pred), generator=generator, device=dev,
                               dtype=tokens.dtype)
    replaced = torch.where(
        u < p_mask, torch.full_like(labels, cfg.mask_index),
        torch.where(u < p_mask + p_rand, rand_words, labels))
    # slots with weight 0 keep the original token
    replaced = torch.where(weights > 0, replaced, labels)
    masked = tokens.clone().scatter_(1, positions, replaced)
    return masked, positions, labels, weights


def mask_regions(generator: Optional[torch.Generator], feats: torch.Tensor,
                 obj_labels: torch.Tensor, img_mask: torch.Tensor,
                 cfg: MaskingConfig, max_pred: Optional[int] = None,
                 selection: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Object masking: zero the features of ~``obj_mask_ratio`` of the
    valid regions, at most ``max_pred`` (default ``cfg.max_pred``) a row.

    feats (B, R, F), obj_labels (B, R), img_mask (B, R) bool -> (masked
    feats (B, R, F), positions (B, P), labels (B, P), weights (B, P),
    target feats (B, P, F)); labels feed MC-MRM, targets MRFR.
    ``selection`` = (positions, weights) skips the draw, so a caller can
    apply another implementation's selection."""
    if selection is None:
        if generator is None:
            raise ValueError("mask_regions needs a generator (or the "
                             "selection passed in)")
        p = max_pred if max_pred is not None else cfg.max_pred
        selection = _select_fixed(generator, img_mask.bool(),
                                  cfg.obj_mask_ratio, p)
    positions, weights = selection
    positions = positions.long()
    labels = obj_labels.gather(1, positions)
    index = positions[..., None].expand(-1, -1, feats.shape[-1])
    target_feats = feats.gather(1, index)
    zero_mask = torch.zeros(feats.shape[:2], dtype=feats.dtype,
                            device=feats.device)
    zero_mask = zero_mask.scatter(1, positions, weights.to(feats.dtype))
    masked_feats = feats * (1.0 - zero_mask)[..., None]
    return masked_feats, positions, labels, weights, target_feats
