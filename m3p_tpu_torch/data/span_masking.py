"""Host-side span masking: MASS segment masking, BART span infilling, and
Poisson object-span noise (a copy of `m3p_tpu/data/span_masking.py`:
`_mask_word`, `mass_mask`, `bart_infill`, `poisson_region_noise`).

  * `mass_mask`   — mask a contiguous ~word_mass fraction of each sentence;
    the decoder predicts the masked span given the span's previous tokens,
    with explicit source-side positions (the reference
    `restricted_mask_sent`)
  * `bart_infill` — replace one Poisson-length span by a single <mask>; the
    decoder reconstructs the full sentence (teacher-forced shift; the
    reference `bart_token_mask_sent`)
  * `poisson_region_noise` — zero a Poisson-length contiguous block of
    region features (the IDA objective's input noise)

These transforms change sequence layouts, so they run on the host (numpy)
before batching; outputs are fixed-shape padded arrays.  The draws keep the
JAX package's order, so the same ``RandomState`` seed gives the same
arrays bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from m3p_tpu_torch.config import PAD_IDX


def _mask_word(rng: np.random.RandomState, words: np.ndarray, mask_index: int,
               n_words: int) -> np.ndarray:
    """80/10/10 replacement over a span (`xtrainer.py mask_word`)."""
    u = rng.rand(len(words))
    out = words.copy()
    out[u < 0.8] = mask_index
    rand_sel = (u >= 0.8) & (u < 0.9)
    out[rand_sel] = rng.randint(4, n_words, size=int(rand_sel.sum()))
    return out


def mass_mask(
    rng: np.random.RandomState,
    tokens: np.ndarray,       # (B, S) batch-major, BOS/EOS/PAD layout
    lengths: np.ndarray,      # (B,)
    word_mass: float,
    mask_index: int,
    n_words: int,
    pad_index: int = PAD_IDX,
) -> Dict[str, np.ndarray]:
    """MASS: mask a contiguous span of ``round(min_len * word_mass)`` tokens
    per sentence (same span length across the batch, reference convention).

    Returns enc_tokens (B,S), enc_len, dec_tokens (B,M) (= span shifted by
    one), dec_pos (B,M) source positions, targets (B,M), target_mask (B,M).
    """
    b, s = tokens.shape
    mask_len = max(int(round(int(lengths.min()) * word_mass)), 1)
    enc_tokens = tokens.copy()
    dec_tokens = np.full((b, mask_len), pad_index, np.int64)
    dec_pos = np.zeros((b, mask_len), np.int64)
    targets = np.full((b, mask_len), pad_index, np.int64)
    for i in range(b):
        li = int(lengths[i])
        # random span start in [1, li - mask_len) (never position 0 / BOS)
        hi = max(li - mask_len, 2)
        start = rng.randint(1, hi)
        pos = np.arange(start, start + mask_len)
        span = tokens[i, pos].copy()
        targets[i] = span
        dec_tokens[i] = tokens[i, pos - 1]        # previous tokens
        dec_pos[i] = pos - 1
        enc_tokens[i, pos] = _mask_word(rng, span, mask_index, n_words)
    return {
        "enc_tokens": enc_tokens.astype(np.int32),
        "enc_len": lengths.astype(np.int32),
        "dec_tokens": dec_tokens.astype(np.int32),
        "dec_pos": dec_pos.astype(np.int32),
        "targets": targets.astype(np.int32),
        "target_mask": (targets != pad_index).astype(np.float32),
    }


def bart_infill(
    rng: np.random.RandomState,
    tokens: np.ndarray,       # (B, S)
    lengths: np.ndarray,
    mask_index: int,
    lam: float = 3.0,
    pad_index: int = PAD_IDX,
) -> Dict[str, np.ndarray]:
    """BART span infilling: one Poisson(lam)-length span collapses to a single
    <mask>; target is the original sentence (teacher-forced).

    Returns src_tokens (B,S), src_len, tgt_tokens (B,S) (= originals),
    tgt_len.
    """
    b, s = tokens.shape
    min_len = int(lengths.min())
    mask_len = int(rng.poisson(lam=lam)) % max(int(round(s * 0.3)), 1)
    mask_len = max(mask_len, 1)
    mask_len = min(mask_len, max(min_len - 3, 1))
    src = np.full_like(tokens, pad_index)
    src_len = np.zeros((b,), np.int32)
    for i in range(b):
        li = int(lengths[i])
        hi = max(li - mask_len, 2)
        start = rng.randint(1, hi)
        kept = np.concatenate([tokens[i, :start], [mask_index],
                               tokens[i, start + mask_len:li]])
        src[i, :len(kept)] = kept
        src_len[i] = len(kept)
    return {
        "src_tokens": src.astype(np.int32),
        "src_len": src_len,
        "tgt_tokens": tokens.astype(np.int32),
        "tgt_len": lengths.astype(np.int32),
    }


def poisson_region_noise(
    rng: np.random.RandomState,
    feats: np.ndarray,        # (B, R, 2048)
    img_len: np.ndarray,
    lam: float = 3.0,
) -> np.ndarray:
    """Zero a Poisson-length contiguous block of regions per image (the IDA /
    image denoising objective's input noise)."""
    out = feats.copy()
    b, r, _ = feats.shape
    for i in range(b):
        li = int(img_len[i])
        span = max(int(rng.poisson(lam=lam)) % max(li, 1), 1)
        start = rng.randint(0, max(li - span, 1))
        out[i, start:start + span] = 0.0
    return out
