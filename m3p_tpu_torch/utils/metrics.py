"""Training statistics and throughput metering (counterpart of
`m3p_tpu/utils/metrics.py`).

Losses arrive as detached device scalars and stay on the device until
`StatsAccumulator.flush`, which brings each task's values to the host in
one copy: a step never waits for the device to report its loss.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict

import torch


class SpeedMeter:
    """Tracks sentences/s and words/s over a sliding flush interval."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.t0 = time.time()
        self.n_sentences = 0
        self.n_words = 0

    def update(self, n_sentences: int, n_words: int) -> None:
        self.n_sentences += n_sentences
        self.n_words += n_words

    def rates(self) -> Dict[str, float]:
        dt = max(time.time() - self.t0, 1e-9)
        return {
            "sentences_per_s": self.n_sentences / dt,
            "words_per_s": self.n_words / dt,
        }


class StatsAccumulator:
    """Per-task loss accumulation with deferred host transfer."""

    def __init__(self, maxlen: int = 1000) -> None:
        self._stats: Dict[str, Deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=maxlen))

    def add(self, name: str, value) -> None:
        """Record a loss: a detached device scalar (kept as it is; nothing
        waits for it) or a host number."""
        if isinstance(value, torch.Tensor):
            value = value.detach()
        self._stats[name].append(value)

    def flush(self) -> Dict[str, float]:
        """The per-task means since the last flush: each task's scalars go
        to the host in one copy."""
        out: Dict[str, float] = {}
        for name, values in self._stats.items():
            if not values:
                continue
            host = torch.stack([torch.as_tensor(v).float().reshape(())
                                for v in values]).cpu().tolist()
            out[name] = sum(host) / len(host)
            values.clear()
        return out

    def format(self) -> str:
        flushed = self.flush()
        return " || ".join(f"{k}: {v:7.4f}" for k, v in sorted(flushed.items()))
