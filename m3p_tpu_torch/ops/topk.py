"""The exact top-k of the port, in `jax.lax.top_k`'s order."""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(values: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the k largest along the last axis, their indices), equal values
    lower index first, as `jax.lax.top_k` orders them (`torch.topk` gives
    no order for ties on CUDA): the first k of a stable descending sort.
    Among bf16 logits cast to fp32, ties at the k-th place are common."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
