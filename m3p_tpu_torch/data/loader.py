"""The data loader of the port (counterpart of `m3p_tpu/data/loader.py`):
`LoadedData`, what `cli/train_x.py` trains and evaluates on, and the host
noise transforms of the generation objectives (a copy of
`m3p_tpu/data/loader.py:67-122`: `make_mass_transform`,
`make_bart_transform`, `make_ae_transform`).

Each turns a text-stream batch (``tokens`` (B, S), ``lengths`` (B,), as
`m3p_tpu_torch.data.synthetic.make_stream_batch` makes them) into the
batch of its loss: MASS for `train.steps.mass_loss`, BART infilling and the
denoising auto-encoder for `train.steps.mt_loss`.  A transform is called
as ``transform(rng, batch, lang_id)`` with a ``np.random.RandomState``;
with ``lang_id`` it adds the language-id arrays.

`load_data`, which builds the datasets, the eval data and the tokenizer
from a data directory, is item 13 of ROADMAP.md: until it lands, callers
pass a `LoadedData` of their own datasets (any object with
``epoch_iterator(batch_size, epoch)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from m3p_tpu_torch.data.noise import add_noise
from m3p_tpu_torch.data.span_masking import bart_infill, mass_mask


@dataclass
class LoadedData:
    """The training datasets by ``(task, name)`` key, the eval data by
    family key (`eval.evaluator.Evaluator.run_all_evals`) and the
    tokenizer (`m3p_tpu/data/loader.py:56-60`)."""

    train_datasets: Dict[Tuple[str, str], Any] = field(default_factory=dict)
    eval_data: Dict[str, Any] = field(default_factory=dict)
    tokenizer: Any = None


def load_data(cfg, dataset_paths: Optional[Dict[str, str]] = None
              ) -> LoadedData:
    """The datasets of a data directory (`m3p_tpu/data/loader.py`'s
    ``load_data``): not ported yet."""
    raise NotImplementedError(
        "loading datasets from a data directory (data/datasets.py, the "
        "feature store, the grain loader) is item 13 of ROADMAP.md; pass "
        "data=LoadedData(...) to cli.train_x.main meanwhile")


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
