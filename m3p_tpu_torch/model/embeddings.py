"""Input embeddings and the AoA region refiner (counterpart of
`m3p_tpu/model/embeddings.py`).

* text: word + learned (or sinusoidal) position + optional language
  embeddings -> LN -> dropout
* image: Linear(2048 -> d) + Linear(5 -> d) summed -> LN -> dropout; no
  positions
* AoA refiner: pre-LN sublayers with a GLU-gated attention-on-attention,
  residual dropout
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from m3p_tpu_torch.model.layers import (
    Dense, Generators, LayerNorm, TransformerFFN, attention_dropout_args,
    dropout, quant_dense)
from m3p_tpu_torch.ops.attention import attention_packed
from m3p_tpu_torch.parallel.tensor_parallel import (
    VocabShard, materialize, shard_of, vocab_parallel_lookup)


class Embedding(nn.Embedding):
    """nn.Embedding whose lookups come back in the compute dtype.  With
    ``vocab`` (the word table under tensor parallelism) the rows are split
    over ``tensor`` and each rank looks up its own words
    (`parallel.tensor_parallel.vocab_parallel_lookup`)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype
        self.vocab: Optional[VocabShard] = None

    def table(self, dtype: torch.dtype) -> torch.Tensor:
        """The table in ``dtype`` as computed with: this rank's rows under
        ``vocab``, whole in every other dimension."""
        return materialize(self.weight, dtype,
                           ("tensor",) if self.vocab is not None else ())

    def rows(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Rows ``ids`` of the table in ``dtype`` (a whole table is looked
        up first and the rows cast, not the table)."""
        if shard_of(self.weight) is None:
            return F.embedding(ids, self.weight).to(dtype)
        table = self.table(dtype)
        if self.vocab is None:
            return F.embedding(ids, table)
        return vocab_parallel_lookup(ids, table, self.vocab)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.rows(ids, self.compute_dtype)


def sinusoidal_table(n_pos: int, dim: int) -> torch.Tensor:
    """Fixed sin/cos position table: sin on even dims, cos on odd,
    frequency 10000^(2*(j//2)/dim)."""
    j = np.arange(dim)
    inv_freq = 1.0 / np.power(10000.0, 2 * (j // 2) / dim)
    enc = np.arange(n_pos)[:, None] * inv_freq[None, :]
    out = np.empty((n_pos, dim), np.float32)
    out[:, 0::2] = np.sin(enc[:, 0::2])
    out[:, 1::2] = np.cos(enc[:, 1::2])
    return torch.from_numpy(out)


class SinusoidalPositions(nn.Module):
    """The fixed position table as a non-persistent buffer (the JAX tree has
    no parameter for it)."""

    def __init__(self, n_pos: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("table", sinusoidal_table(n_pos, dim),
                             persistent=False)
        self.compute_dtype = dtype

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return self.table[positions].to(self.compute_dtype)


class TextEmbeddings(nn.Module):
    """Word + position + optional language embeddings, then ``ln_emb`` and
    dropout."""

    def __init__(self, n_words: int, n_langs: int, dim: int,
                 max_positions: int, sinusoidal: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.word = Embedding(n_words, dim, dtype)
        if sinusoidal:
            self.position = SinusoidalPositions(max_positions, dim, dtype)
        else:
            self.position = Embedding(max_positions, dim, dtype)
        self.lang = Embedding(n_langs, dim, dtype)
        self.ln_emb = LayerNorm(dim, dtype)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.word(tokens)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                langs: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[Generators] = None,
                token_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``token_embeds`` (B, S, D), when given, replaces the word
        lookup (freeLB's perturbed embeddings; `m3p_tpu/model/
        embeddings.py:83-99`)."""
        x = self.word(tokens) if token_embeds is None else token_embeds
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = x + self.position(positions)
        if langs is not None:
            x = x + self.lang(langs)
        return dropout(self.ln_emb(x), self.dropout, deterministic,
                       generator)


class ImageEmbeddings(nn.Module):
    """Region feature + box geometry [+ class distribution] projections,
    summed, then LN and dropout (`m3p_tpu/model/embeddings.py:101-124`).

    The distribution projection ``dist_proj`` exists, as in the JAX tree,
    only where its weights were made or loaded: a model is built without it
    (the JAX init passes no ``dist``), `add_dist_proj` adds it (a reference
    ``.pth`` that holds it, `checkpoint.load_weights`), and a forward given
    ``dist`` without it raises."""

    def __init__(self, dim: int, feat_dim: int = 2048, loc_dim: int = 5,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.img_proj = Dense(feat_dim, dim, dtype)
        self.loc_proj = Dense(loc_dim, dim, dtype)
        self.dist_proj: Optional[Dense] = None
        self.ln = LayerNorm(dim, dtype)

    def add_dist_proj(self, dist_dim: int = 1600) -> Dense:
        """Add the (dist_dim -> dim) projection of the class distribution,
        zero-initialised, on the module's device."""
        ref = self.img_proj
        proj = Dense(dist_dim, ref.out_features, ref.compute_dtype).to(
            ref.weight.device)
        with torch.no_grad():
            proj.weight.zero_()
            proj.bias.zero_()
        self.dist_proj = proj
        return proj

    def forward(self, feats: torch.Tensor, locs: torch.Tensor,
                dist: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[Generators] = None) -> torch.Tensor:
        x = self.img_proj(feats) + self.loc_proj(locs)
        if dist is not None:
            if self.dist_proj is None:
                raise ValueError("a class distribution needs the dist_proj "
                                 "weights (ImageEmbeddings.add_dist_proj, or "
                                 "a checkpoint that holds them)")
            x = x + self.dist_proj(dist)
        x = self.ln(x)
        return dropout(x, self.dropout, deterministic, generator)


class AoAAttention(nn.Module):
    """Attention whose context is concatenated with the query and GLU-gated
    (``aoa``), in place of an output projection.  ``attention_dropout``
    drops attention weights inside the kernels; ``dropout_aoa`` drops the
    gate's input (`m3p_tpu/model/embeddings.py:160-194`).  ``quant``
    "int8", "int8_bwd" or "int8_all" routes the gate's GEMM through the
    dynamic int8 GEMMs (`:195-200`)."""

    def __init__(self, n_heads: int, dim: int,
                 dtype: torch.dtype = torch.float32, dropout_aoa: float = 0.0,
                 attention_dropout: float = 0.0, quant: str = "none"):
        super().__init__()
        self.n_heads = n_heads
        self.dropout_aoa = dropout_aoa
        self.attention_dropout = attention_dropout
        self.q_lin = Dense(dim, dim, dtype)
        self.k_lin = Dense(dim, dim, dtype)
        self.v_lin = Dense(dim, dim, dtype)
        self.aoa = quant_dense(2 * dim, 2 * dim, dtype, quant)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[Generators] = None) -> torch.Tensor:
        rate, seed = attention_dropout_args(self.attention_dropout,
                                            deterministic, generator)
        ctx = attention_packed(self.q_lin(x), self.k_lin(x), self.v_lin(x),
                               pad_mask, self.n_heads, dropout_rate=rate,
                               dropout_seed=seed)
        gate_in = dropout(torch.cat([ctx, x], dim=-1), self.dropout_aoa,
                          deterministic, generator)
        a, gate = self.aoa(gate_in).chunk(2, dim=-1)
        return a * torch.sigmoid(gate)


class AoARefinerLayer(nn.Module):
    """Pre-LN: x = x + drop(aoa(LN(x))); x = x + drop(ffn(LN(x))), the FFN
    applying its own output dropout first, as in the JAX layer.  ``quant``
    goes to the FFN only, as the JAX layer passes it
    (`m3p_tpu/model/embeddings.py:218-242`); the model builds its refiner
    without it (`m3p_tpu/model/transformer.py:70-75`)."""

    def __init__(self, n_heads: int, dim: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 attention_dropout: float = 0.0, quant: str = "none"):
        super().__init__()
        self.dropout = dropout
        self.ln_attn = LayerNorm(dim, dtype)
        self.aoa_attn = AoAAttention(n_heads, dim, dtype, dropout,
                                     attention_dropout)
        self.ln_ffn = LayerNorm(dim, dtype)
        self.ffn = TransformerFFN(dim, ffn_dim, True, dtype, dropout, quant)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[Generators] = None) -> torch.Tensor:
        h = self.aoa_attn(self.ln_attn(x), pad_mask, deterministic, generator)
        x = x + dropout(h, self.dropout, deterministic, generator)
        h = self.ffn(self.ln_ffn(x), deterministic, generator)
        return x + dropout(h, self.dropout, deterministic, generator)


class AoARefiner(nn.Module):
    """``n_layers`` refiner layers (``layer_<i>``) and a final ``ln_out``;
    ``quant`` goes to every layer."""

    def __init__(self, n_heads: int, dim: int, ffn_dim: int, n_layers: int = 3,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 attention_dropout: float = 0.0, quant: str = "none"):
        super().__init__()
        self.layers = []
        for i in range(n_layers):
            layer = AoARefinerLayer(n_heads, dim, ffn_dim, dtype, dropout,
                                    attention_dropout, quant)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        self.ln_out = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[Generators] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, pad_mask, deterministic, generator)
        return self.ln_out(x)
