"""Prediction heads (counterpart of `m3p_tpu/model/heads.py`).

The serving slice calls only the ITM `Pooler`; the other heads are here so
that every parameter of the JAX tree loads strictly.  `AdaptiveSoftmax`
waits for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from m3p_tpu_torch.model.layers import Dense, LayerNorm
from m3p_tpu_torch.ops.activations import gelu_erf
from m3p_tpu_torch.ops.quant import Q8Table, int8_matmul_nt_pre


class PredLayer(nn.Module):
    """Vocab logits through the tied word table (or an own ``weight`` when
    untied) plus a per-word bias.

    With an int8 table ``q8_emb`` (frozen-weight int8 inference,
    `m3p_tpu/model/heads.py:94-126`) the GEMM runs through
    `int8_matmul_nt_pre` at every row count; the table's rows are padded
    to a multiple of 8 (the CUDA GEMM's rule for N) and the logits cut
    back to ``n_words``."""

    def __init__(self, n_words: int, dim: int, tied: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(n_words))
        if not tied:
            self.weight = nn.Parameter(torch.empty(n_words, dim))
        self.compute_dtype = dtype
        self.q8_emb: Optional[Q8Table] = None

    def capture_q8(self, table: torch.Tensor) -> None:
        """Quantize the (n_words, D) table (the tied word embedding or the
        own weight) into ``q8_emb``."""
        n = table.shape[0]
        self.q8_emb = Q8Table(table, self.compute_dtype, -(-n // 8) * 8)

    def forward(self, x: torch.Tensor,
                embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.compute_dtype
        if self.q8_emb is not None:
            q8 = self.q8_emb
            x2d = x.reshape(-1, x.shape[-1]).to(dt)
            logits = int8_matmul_nt_pre(x2d, q8.wq, q8.sw.t())[:, :q8.n]
            return (logits + self.bias.to(dt)).reshape(*x.shape[:-1], q8.n)
        table = self.weight if embedding is None else embedding
        return F.linear(x.to(dt), table.to(dt), self.bias.to(dt))


class ObjPredLayer(nn.Module):
    """dense + gelu + LN, then Linear(d -> n_obj_classes)."""

    def __init__(self, n_obj_classes: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transform_dense = Dense(dim, dim, dtype)
        self.transform_ln = LayerNorm(dim, dtype)
        self.proj = Dense(dim, n_obj_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.transform_ln(gelu_erf(self.transform_dense(x))))


class Pooler(nn.Module):
    """dense + tanh over the first token, then a 1-d score: (B, S, D) ->
    (B, 1)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(dim, dim, dtype)
        self.score = Dense(dim, 1, dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.score(torch.tanh(self.dense(hidden[:, 0])))


class MRFRHead(nn.Module):
    """Masked-region feature regression: Linear(d -> 2048)."""

    def __init__(self, dim: int, feat_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(dim, feat_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)
