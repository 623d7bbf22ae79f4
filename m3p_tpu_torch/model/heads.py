"""Prediction heads (counterpart of `m3p_tpu/model/heads.py`).

`PredLayer` is the word head (tied, or with its own weight), in float,
frozen-weight int8 or dynamic int8 (``head_quant="int8_bwd"``);
`AdaptiveSoftmax` the ``asm`` head in its place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from m3p_tpu_torch.model.layers import Dense, LayerNorm
from m3p_tpu_torch.ops.activations import gelu_erf
from m3p_tpu_torch.ops.quant import (
    Q8Table, int8_matmul, int8_matmul_nt, int8_matmul_nt_pre)
from m3p_tpu_torch.parallel.mesh import Mesh
from m3p_tpu_torch.parallel.tensor_parallel import (
    VocabShard, copy_to, gather_vocab, materialize,
    vocab_parallel_log_softmax, vocab_shard)


class AdaptiveSoftmax(nn.Module):
    """The adaptive softmax (`m3p_tpu/model/heads.py:28-68`): the ``head``
    scores the ``cutoffs[0]`` most frequent words plus one slot per tail
    cluster; tail cluster i projects down to max(int(dim / div^(i+1)), 1)
    (``tail_<i>_proj``) and scores its word range (``tail_<i>_out``).
    Returns the full normalized log-probabilities (..., n_words) in the
    compute dtype: their logsumexp is 0, so they stand in for the word
    head's logits in the losses and in generation.

    Under tensor parallelism (`tensor_parallel`) the head's and the tails'
    output rows are split over ``tensor`` as JAX splits ``head`` and
    ``tail_<i>_out`` ("vocab"), each a column-parallel product: each rank
    normalizes its columns with the max and the sum of exponentials taken
    over ``tensor`` (`vocab_parallel_log_softmax`), and the log-probs are
    gathered whole on every rank."""

    def __init__(self, n_words: int, dim: int,
                 cutoffs: Tuple[int, ...] = (8000, 20000),
                 div_value: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.edges = list(cutoffs) + [n_words]
        self.compute_dtype = dtype
        n_clusters = len(self.edges) - 1
        self.head = Dense(dim, self.edges[0] + n_clusters, dtype)
        self.tails = []
        for i in range(n_clusters):
            proj_dim = max(int(dim / div_value ** (i + 1)), 1)
            proj = Dense(dim, proj_dim, dtype, bias=False)
            out = Dense(proj_dim, self.edges[i + 1] - self.edges[i], dtype,
                        bias=False)
            self.add_module(f"tail_{i}_proj", proj)
            self.add_module(f"tail_{i}_out", out)
            self.tails.append((proj, out))
        # the words of each scoring Dense (head, then each tail) held on
        # this rank under tensor parallelism
        self.vocabs: list = [None] * (n_clusters + 1)

    def tensor_parallel(self, mesh: Mesh) -> None:
        """Score this rank's rows of the head and of each tail's output
        over ``mesh``'s ``tensor`` axis (the parameters already hold their
        slices, `parallel.sharding`)."""
        outs = [self.head] + [out for _, out in self.tails]
        for lin in outs:
            lin.keep = ("tensor",)
        self.vocabs = [vocab_shard(mesh, lin.out_features) for lin in outs]

    @staticmethod
    def _log_probs(lin: Dense, x: torch.Tensor,
                   vocab: Optional[VocabShard]) -> torch.Tensor:
        """fp32 log-softmax of ``lin(x)``, whole on every rank."""
        if vocab is not None:
            x = copy_to(x, vocab.mesh, "tensor")
            logits = lin(x)[..., :vocab.n]
        else:
            logits = lin(x)
        return gather_vocab(vocab_parallel_log_softmax(logits, vocab), vocab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head_lp = self._log_probs(self.head, x, self.vocabs[0])
        cut = self.edges[0]
        parts = [head_lp[..., :cut]]
        for i, (proj, out) in enumerate(self.tails):
            tail_lp = self._log_probs(out, proj(x), self.vocabs[i + 1])
            parts.append(head_lp[..., cut + i:cut + i + 1] + tail_lp)
        return torch.cat(parts, dim=-1).to(self.compute_dtype)


class PredLayer(nn.Module):
    """Vocab logits through the tied word table (or an own ``weight`` when
    untied) plus a per-word bias.

    With an int8 table ``q8_emb`` (frozen-weight int8 inference,
    `m3p_tpu/model/heads.py:94-126`) the GEMM runs through
    `int8_matmul_nt_pre` at every row count; the table's rows are padded
    to a multiple of 8 (the CUDA GEMM's rule for N) and the logits cut
    back to ``n_words``.

    ``quant="int8_bwd"`` (`:127-139`) routes the GEMM through the dynamic
    int8 GEMMs, forward and backward: tied through `int8_matmul_nt` over
    the (V, D) table, untied through `int8_matmul` over the (D, V)
    kernel.

    Under tensor parallelism (``vocab``) the table's rows and the bias are
    this rank's words (in a shard padded where the vocabulary does not
    divide), and the logits' columns are this rank's real words: the int8
    quantizers along the vocabulary (the dgrad's per-row scale of g and
    per-column scale of the table) take their amax over ``tensor``, and an
    int8 table holds this rank's rows with their whole-weight scales."""

    def __init__(self, n_words: int, dim: int, tied: bool = True,
                 dtype: torch.dtype = torch.float32, quant: str = "none"):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(n_words))
        if not tied:
            self.weight = nn.Parameter(torch.empty(n_words, dim))
        self.compute_dtype = dtype
        self.quant = quant
        self.q8_emb: Optional[Q8Table] = None
        self.vocab: Optional[VocabShard] = None

    def _real(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of this rank's real words (all rows without
        ``vocab``)."""
        return t if self.vocab is None else t[:self.vocab.n]

    def _bias(self, dtype: torch.dtype) -> torch.Tensor:
        keep = ("tensor",) if self.vocab is not None else ()
        return self._real(materialize(self.bias, dtype, keep))

    def capture_q8(self, table: torch.Tensor) -> None:
        """Quantize the (n_words, D) table (the tied word embedding or the
        own weight, this rank's rows under ``vocab``) into ``q8_emb``."""
        table = self._real(table)
        n = table.shape[0]
        self.q8_emb = Q8Table(table, self.compute_dtype, -(-n // 8) * 8)

    def forward(self, x: torch.Tensor,
                embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.compute_dtype
        if self.q8_emb is not None:
            q8 = self.q8_emb
            x2d = x.reshape(-1, x.shape[-1]).to(dt)
            logits = int8_matmul_nt_pre(x2d, q8.wq, q8.sw.t())[:, :q8.n]
            return (logits + self._bias(dt)).reshape(*x.shape[:-1], q8.n)
        keep = ("tensor",) if self.vocab is not None else ()
        table = self._real(materialize(self.weight, dt, keep)
                           if embedding is None else embedding.to(dt))
        bias = self._bias(dt)
        if self.quant == "int8_bwd":
            x2d = x.reshape(-1, x.shape[-1])
            if embedding is None:
                logits = int8_matmul(x2d, table.t())
            else:
                n_over = (None if self.vocab is None
                          else (self.vocab.mesh, "tensor"))
                logits = int8_matmul_nt(x2d, table, n_over)
            n = table.shape[0]
            return logits.reshape(*x.shape[:-1], n) + bias
        return F.linear(x.to(dt), table, bias)


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
