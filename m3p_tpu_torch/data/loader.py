"""Host noise transforms of the generation objectives (a copy of
`m3p_tpu/data/loader.py:67-122`: `make_mass_transform`,
`make_bart_transform`, `make_ae_transform`).

Each turns a text-stream batch (``tokens`` (B, S), ``lengths`` (B,), as
`m3p_tpu_torch.data.synthetic.make_stream_batch` makes them) into the
batch of its loss: MASS for `train.steps.mass_loss`, BART infilling and the
denoising auto-encoder for `train.steps.mt_loss`.  A transform is called
as ``transform(rng, batch, lang_id)`` with a ``np.random.RandomState``;
with ``lang_id`` it adds the language-id arrays.

The rest of the JAX loader (the datasets, the task DSLs, the eval data)
is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from m3p_tpu_torch.data.noise import add_noise
from m3p_tpu_torch.data.span_masking import bart_infill, mass_mask


def make_mass_transform(word_mass: float, mask_index: int,
                        n_words: int) -> Callable:
    """Stream batch -> MASS batch (`train.steps.mass_loss` layout)."""

    def transform(rng, batch, lang_id):
        out = mass_mask(rng, batch["tokens"], batch["lengths"], word_mass,
                        mask_index, n_words)
        if lang_id is not None:
            out["langs"] = np.full_like(out["enc_tokens"], lang_id)
        return out

    return transform


def make_bart_transform(mask_index: int,
                        noise: Optional[Tuple[float, float, float]] = None
                        ) -> Callable:
    """Stream batch -> BART-infilled seq2seq batch (`mt_loss` layout).

    ``noise=(shuffle_k, dropout_p, blank_p)`` additionally word-noises the
    infilled source (``--use_noise``)."""

    def transform(rng, batch, lang_id):
        out = bart_infill(rng, batch["tokens"], batch["lengths"], mask_index)
        if noise is not None:
            out["src_tokens"], out["src_len"] = add_noise(
                rng, out["src_tokens"], out["src_len"], *noise, mask_index)
        if lang_id is not None:
            out["src_langs"] = np.full_like(out["src_tokens"], lang_id)
            out["tgt_langs"] = np.full_like(out["tgt_tokens"], lang_id)
        return out

    return transform


def make_ae_transform(shuffle_k: float, dropout_p: float, blank_p: float,
                      mask_index: int) -> Callable:
    """Stream batch -> denoising-AE seq2seq batch: reconstruct the clean
    sentence from its word-noised version (`add_noise`)."""

    def transform(rng, batch, lang_id):
        noised, lens = add_noise(rng, batch["tokens"], batch["lengths"],
                                 shuffle_k, dropout_p, blank_p, mask_index)
        out = {"src_tokens": noised, "src_len": lens,
               "tgt_tokens": batch["tokens"], "tgt_len": batch["lengths"]}
        if lang_id is not None:
            out["src_langs"] = np.full_like(noised, lang_id)
            out["tgt_langs"] = np.full_like(batch["tokens"], lang_id)
        return out

    return transform
