"""Synthetic batches shaped like the real pipeline's (a copy of
`m3p_tpu/data/synthetic.py:18-111`: `_random_tokens`, `make_pretrain_batch`,
`make_retrieval_batch`, `make_caption_batch`, `make_mt_batch`,
`make_stream_batch`, `make_slide_batch`).

numpy only, so the same ``RandomState`` gives the same batch here and in the
JAX package.  Shapes follow the reference recipes: captions up to
``max_len`` tokens, ``max_regions`` regions with 2048-d features and 5-d box
geometry, candidate grids of ``sample_n``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from m3p_tpu_torch.config import BOS_IDX, EOS_IDX, PAD_IDX


def _random_tokens(rng, b, s, n_words, min_len=5):
    lengths = rng.randint(min_len, s + 1, size=b)
    toks = np.full((b, s), PAD_IDX, np.int32)
    toks[:, 0] = BOS_IDX
    for i, l in enumerate(lengths):
        if l > 2:
            toks[i, 1:l - 1] = rng.randint(4, n_words - 1, size=l - 2)
        toks[i, l - 1] = EOS_IDX
    return toks, lengths.astype(np.int32)


def make_pretrain_batch(rng, batch_size: int, sample_n: int, max_len: int,
                        max_regions: int, n_words: int,
                        with_clcm: bool = False,
                        clcm_len: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
    """A grid-flattened MCT pre-training batch (BN = batch_size *
    sample_n): captions, regions with object labels, the index of each
    group's positive and, ``with_clcm``, concatenated-caption CLCM pairs of
    ``clcm_len`` (default 2 * max_len) tokens with binary labels."""
    bn = batch_size * sample_n
    tokens, text_len = _random_tokens(rng, bn, max_len, n_words)
    batch = {
        "tokens": tokens,
        "text_len": text_len,
        "feats": rng.randn(bn, max_regions, 2048).astype(np.float32),
        "locs": rng.rand(bn, max_regions, 5).astype(np.float32),
        "obj_labels": rng.randint(0, 1600, (bn, max_regions)).astype(np.int32),
        "img_len": np.full((bn,), max_regions, np.int32),
        "pos_label": rng.randint(0, sample_n, (batch_size,)).astype(np.int32),
    }
    if with_clcm:
        cl = clcm_len or 2 * max_len
        ctok, clen = _random_tokens(rng, bn, cl, n_words)
        batch["clcm_tokens"] = ctok
        batch["clcm_len"] = clen
        batch["clcm_labels"] = rng.randint(0, 2, (bn,)).astype(np.int32)
    return batch


def make_retrieval_batch(rng, batch_size, sample_n, max_len, max_regions,
                         n_words) -> Dict[str, np.ndarray]:
    """An ITM fine-tune batch: ``batch_size`` groups of ``sample_n``
    candidate pairs (BN = batch_size * sample_n rows) and the index of each
    group's positive."""
    bn = batch_size * sample_n
    tokens, text_len = _random_tokens(rng, bn, max_len, n_words)
    return {
        "tokens": tokens,
        "text_len": text_len,
        "feats": rng.randn(bn, max_regions, 2048).astype(np.float32),
        "locs": rng.rand(bn, max_regions, 5).astype(np.float32),
        "img_len": np.full((bn,), max_regions, np.int32),
        "pos_label": rng.randint(0, sample_n, (batch_size,)).astype(np.int32),
    }


def make_caption_batch(rng, batch_size, max_len, max_regions,
                       n_words) -> Dict[str, np.ndarray]:
    """A captioning batch: ``batch_size`` images of ``max_regions`` regions
    and a caption of up to ``max_len`` tokens each."""
    tokens, tgt_len = _random_tokens(rng, batch_size, max_len, n_words)
    return {
        "tokens": tokens,
        "tgt_len": tgt_len,
        "feats": rng.randn(batch_size, max_regions, 2048).astype(np.float32),
        "locs": rng.rand(batch_size, max_regions, 5).astype(np.float32),
        "img_len": np.full((batch_size,), max_regions, np.int32),
    }


def make_mt_batch(rng, batch_size, max_len, n_words) -> Dict[str, np.ndarray]:
    """A translation batch: source and target sentences of up to
    ``max_len`` tokens."""
    src, src_len = _random_tokens(rng, batch_size, max_len, n_words)
    tgt, tgt_len = _random_tokens(rng, batch_size, max_len, n_words)
    return {"src_tokens": src, "src_len": src_len,
            "tgt_tokens": tgt, "tgt_len": tgt_len}


def make_stream_batch(rng, batch_size, bptt, n_words) -> Dict[str, np.ndarray]:
    """A text-stream batch for the MLM objectives: ``batch_size`` rows of
    ``bptt`` random word ids, all full length (a copy of
    `m3p_tpu/data/synthetic.py:93-97`)."""
    return {
        "tokens": rng.randint(4, n_words - 1,
                              (batch_size, bptt)).astype(np.int32),
        "lengths": np.full((batch_size,), bptt, np.int32),
    }


def make_slide_batch(rng, batch_size, max_len, max_regions,
                     n_words) -> Dict[str, np.ndarray]:
    """A slide-text matching batch: captions, regions and a binary label
    per pair."""
    tokens, text_len = _random_tokens(rng, batch_size, max_len, n_words)
    return {
        "tokens": tokens,
        "text_len": text_len,
        "feats": rng.randn(batch_size, max_regions, 2048).astype(np.float32),
        "locs": rng.rand(batch_size, max_regions, 5).astype(np.float32),
        "img_len": np.full((batch_size,), max_regions, np.int32),
        "labels": rng.randint(0, 2, (batch_size,)).astype(np.int32),
    }
