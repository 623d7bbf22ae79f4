"""Word-level input noise (denoising auto-encoding) and batch concatenation
(a copy of `m3p_tpu/data/noise.py`: `word_shuffle`, `word_dropout`,
`word_blank`, `add_noise`, `concat_batches`).

numpy over an explicit ``np.random.RandomState``, drawn in the JAX
package's order, so the same seed gives the same arrays bit for bit:

  * word_shuffle — bounded local permutation: word j gets score j + U(0,k),
    sort by score (words move at most k positions); BOS fixed
  * word_dropout — drop words with prob p (keep >= 1 real word); BOS/EOS kept
  * word_blank  — replace words with <mask> with prob p; BOS/EOS kept
  * concat_batches — [x1 </s>-terminated ; x2] with per-side language ids and
    optionally reset positions (TLM-style pairs)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from m3p_tpu_torch.config import PAD_IDX


def word_shuffle(rng: np.random.RandomState, tokens: np.ndarray,
                 lengths: np.ndarray, k: float) -> np.ndarray:
    """tokens (B, S) with BOS at 0 and EOS at lengths-1."""
    if k == 0:
        return tokens
    assert k > 1
    out = tokens.copy()
    b, s = tokens.shape
    noise = rng.uniform(0, k, size=(b, s))
    for i in range(b):
        li = int(lengths[i])
        n = li - 2  # interior words (exclude BOS and EOS)
        if n <= 1:
            continue
        scores = np.arange(n) + noise[i, :n]
        perm = scores.argsort()
        out[i, 1:1 + n] = tokens[i, 1:1 + n][perm]
    return out


def word_dropout(rng: np.random.RandomState, tokens: np.ndarray,
                 lengths: np.ndarray, p: float,
                 pad_index: int = PAD_IDX
                 ) -> Tuple[np.ndarray, np.ndarray]:
    if p == 0:
        return tokens, lengths
    assert 0 < p < 1
    b, s = tokens.shape
    out = np.full_like(tokens, pad_index)
    new_lengths = np.zeros_like(lengths)
    for i in range(b):
        li = int(lengths[i])
        interior = tokens[i, 1:li - 1]
        keep = rng.rand(len(interior)) >= p
        kept = interior[keep]
        if len(kept) == 0 and len(interior) > 0:
            kept = interior[rng.randint(len(interior)):][:1]
        new = np.concatenate([tokens[i, :1], kept, tokens[i, li - 1:li]])
        out[i, :len(new)] = new
        new_lengths[i] = len(new)
    return out, new_lengths


def word_blank(rng: np.random.RandomState, tokens: np.ndarray,
               lengths: np.ndarray, p: float, mask_index: int) -> np.ndarray:
    if p == 0:
        return tokens
    assert 0 < p < 1
    out = tokens.copy()
    b, s = tokens.shape
    for i in range(b):
        li = int(lengths[i])
        blank = rng.rand(li - 2) < p
        interior = out[i, 1:li - 1]
        interior[blank] = mask_index
        out[i, 1:li - 1] = interior
    return out


def add_noise(rng: np.random.RandomState, tokens: np.ndarray,
              lengths: np.ndarray, shuffle_k: float = 3.0,
              dropout_p: float = 0.1, blank_p: float = 0.0,
              mask_index: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """shuffle -> dropout [-> blank], the reference `add_noise` composition."""
    tokens = word_shuffle(rng, tokens, lengths, shuffle_k)
    tokens, lengths = word_dropout(rng, tokens, lengths, dropout_p)
    if blank_p > 0:
        tokens = word_blank(rng, tokens, lengths, blank_p, mask_index)
    return tokens, lengths


def concat_batches(
    x1: np.ndarray, len1: np.ndarray, lang1_id: int,
    x2: np.ndarray, len2: np.ndarray, lang2_id: int,
    pad_index: int = PAD_IDX,
    reset_positions: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate two batches sentence-wise (TLM pairs).

    Returns (tokens (B, L), lengths, positions (B, L), langs (B, L)).
    x2's leading BOS is dropped so the pair reads ``<s> a … </s> b … </s>``.
    """
    b = x1.shape[0]
    lengths = len1 + len2 - 1
    max_len = int(lengths.max())
    tokens = np.full((b, max_len), pad_index, x1.dtype)
    positions = np.zeros((b, max_len), np.int32)
    langs = np.zeros((b, max_len), np.int32)
    for i in range(b):
        l1, l2 = int(len1[i]), int(len2[i]) - 1
        tokens[i, :l1] = x1[i, :l1]
        tokens[i, l1:l1 + l2] = x2[i, 1:l2 + 1]
        positions[i, :l1] = np.arange(l1)
        positions[i, l1:l1 + l2] = (np.arange(l2)
                                    if reset_positions else
                                    np.arange(l1, l1 + l2))
        langs[i, :l1] = lang1_id
        langs[i, l1:l1 + l2] = lang2_id
    return tokens, lengths.astype(np.int32), positions, langs
