"""Language / language-pair sampling and per-iteration task-order shuffling
(a copy of `m3p_tpu/utils/sampling.py`: the same seed gives the same order).

Parity with the reference (`utils.py:296-394`): corpus-size-proportional sampling
probabilities smoothed by ``p^coeff`` (coeff<1 upsamples low-resource languages),
and a per-iteration random task order with ``n`` samples drawn per step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Key = Union[str, Tuple[str, str], Tuple[str, Optional[str]]]


def set_sampling_probs(sizes: Dict[Key, int], coeff: float) -> Dict[Key, float]:
    """Smoothed sampling probabilities ``p_i ∝ size_i^coeff`` over corpora."""
    assert coeff > 0
    keys = list(sizes.keys())
    probs = np.array([max(sizes[k], 1) for k in keys], dtype=np.float64)
    probs = probs / probs.sum()
    probs = probs ** coeff
    probs = probs / probs.sum()
    return {k: float(p) for k, p in zip(keys, probs)}


def shuf_order(
    items: Sequence[Key],
    probs: Optional[Dict[Key, float]] = None,
    n: int = 3,
    rng: Optional[np.random.RandomState] = None,
) -> List[Key]:
    """Sample a random task order for one training iteration.

    With ``probs`` given, draws ``n`` items with replacement according to the
    smoothed probabilities; otherwise returns a uniform permutation repeated to
    length ``n`` (reference behavior: `utils.py:365-394`).
    """
    if len(items) == 0:
        return []
    rng = rng or np.random.RandomState()
    items = list(items)
    if probs is None:
        out: List[Key] = []
        while len(out) < n:
            perm = rng.permutation(len(items))
            out.extend(items[i] for i in perm)
        return out[:n]
    p = np.array([probs[k] for k in items], dtype=np.float64)
    p = p / p.sum()
    idx = rng.choice(len(items), size=n, replace=True, p=p)
    return [items[i] for i in idx]
