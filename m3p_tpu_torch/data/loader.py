"""The data loader of the port (a copy of `m3p_tpu/data/loader.py`):
`load_data`, which builds the datasets, the eval data and the tokenizer of
a data directory from the config's paths and task-step flags, the
`LoadedData` it returns, and the host noise transforms of the generation
objectives (`make_mass_transform`, `make_bart_transform`,
`make_ae_transform`).

``load_data`` returns:
  * train_datasets: {(task, name): dataset}, what the `Trainer` steps
  * eval_data: what `Evaluator.run_all_evals` reads, one entry per eval
    family, with per-language keys suffixed ``family.lang`` in runs of
    several languages

The directory layout:
  * captions:   ``<dataset>_path/{train,valid,test}.<lang>.pkl``, a pickled
                dict image_id -> [caption, ...]; else the reference's one
                pkl for every split, ``data_path/uvl_captions/<name>.<lang>
                .pkl`` (``<name>.pkl`` for en), split membership from the
                split's h5
  * features:   ``input_fea_dir/<dataset>/*.h5`` (else ``data_path/
                <dataset>/``), reference-layout shards; ``<split>*.h5``
                serves that split, and a single shard serves every split
  * mono text:  ``data_path/{train,valid}.<lang>.npy``, an int32 token stream
  * parallel:   ``data_path/<split>.<src>-<tgt>.<side>.txt``, plain text
  * MILD:       ``<mild_path>/{train,test}.<lang>.{h5,pkl}`` of (query,
                passage) pairs, ``test.caption.<lang>.pkl``
  * slides:     ``<slide_path>/*.h5`` and ``{train,test}.tsv`` of
                image_id, text, label
  * bilingual dictionaries for MCT: ``cross_lingual_path/<l1>-<l2>.txt``
                (else ``data_path/dictionary/``)
  * shard schedule: ``train_order_path/<name>_train_order.json``

Missing data for a requested task raises `FileNotFoundError` at load time
(a mistyped path must not silently train half the recipe);
``--allow_missing_data`` warns and skips instead.  Optional artifacts
(valid/test splits for the evals) are skipped either way.

A shard is read with ``h5py``, imported when the first one is opened: on a
machine without it, the text families load and the image families need a
`LoadedData` over an in-memory store.  Over several processes
``--split_data`` (without the row loader) splits the mono streams by feeder
and ``--ft_all`` gives each process one language, by the process's batch
shard (`parallel.mesh.batch_shards`).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from m3p_tpu_torch.config import TrainConfig, parse_steps
from m3p_tpu_torch.data.clag import Clager, load_bilingual_dict
from m3p_tpu_torch.data.datasets import (
    CaptionDataset, MILDDataset, NoisedStreamDataset, ParallelDataset,
    PCDataset, PretrainCaptionDataset, PretrainDataset, RetrievalDataset,
    SlideDataset, StreamDataset, build_eval_retrieval_arrays)
from m3p_tpu_torch.data.features import RegionFeatureStore
from m3p_tpu_torch.data.noise import add_noise
from m3p_tpu_torch.data.span_masking import bart_infill, mass_mask

logger = logging.getLogger("m3p_tpu_torch")

EVAL_BATCHES = 8  # validation batches cached per (family, lang)


@dataclass
class LoadedData:
    """The training datasets by ``(task, name)`` key, the eval data by
    family key (`eval.evaluator.Evaluator.run_all_evals`) and the
    tokenizer (`m3p_tpu/data/loader.py:56-60`)."""

    train_datasets: Dict[Tuple[str, str], Any] = field(default_factory=dict)
    eval_data: Dict[str, Any] = field(default_factory=dict)
    tokenizer: Any = None


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


# ---------------------------------------------------------------------------
# file helpers
# ---------------------------------------------------------------------------


def _process() -> Tuple[int, int]:
    """(index, count) of this process's batch shard, the JAX loader's
    (process_index, process_count): from the current mesh (ranks that
    differ only in ``seq`` feed the same data), else the process group's
    (rank, world size), else (0, 1)."""
    from m3p_tpu_torch.parallel.mesh import batch_shards

    return batch_shards()


def _data_missing(cfg: TrainConfig, what: str, path: str) -> None:
    """A task the step DSL requested has no data on disk: raise (reference
    `check_data_params` semantics) unless ``--allow_missing_data``."""
    msg = f"{what}: {path}"
    if cfg.data.allow_missing_data:
        logger.warning("%s — task skipped (--allow_missing_data)", msg)
        return
    raise FileNotFoundError(
        f"{msg} — requested by the task-step flags; fix the path or pass "
        "--allow_missing_data to deliberately train without it")


def _load_captions(path: str, warn: bool = True
                   ) -> Optional[Dict[str, List[str]]]:
    if not os.path.exists(path):
        if warn:
            logger.warning("captions not found: %s", path)
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def _load_parallel(data_path: str, split: str, src: str, tgt: str
                   ) -> Optional[Tuple[List[str], List[str]]]:
    base = os.path.join(data_path, f"{split}.{src}-{tgt}")
    src_path, tgt_path = f"{base}.{src}.txt", f"{base}.{tgt}.txt"
    if not (os.path.exists(src_path) and os.path.exists(tgt_path)):
        return None
    with open(src_path, encoding="utf-8") as f:
        src_texts = [l.rstrip("\n") for l in f]
    with open(tgt_path, encoding="utf-8") as f:
        tgt_texts = [l.rstrip("\n") for l in f]
    return src_texts, tgt_texts


def _load_tokenizer(cfg: TrainConfig):
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    if cfg.data.vocab_path and os.path.exists(cfg.data.vocab_path):
        return XLMRTokenizer(cfg.data.vocab_path)
    logger.warning("vocab_path missing (%s) — no tokenizer available",
                   cfg.data.vocab_path)
    return None


def _build_clager(cfg: TrainConfig, paths_root: str) -> Optional[Clager]:
    if not (cfg.data.use_mct or cfg.src_lgs):
        return None
    if not paths_root:
        # reference convention: MCT lexicons live under
        # ``data_path/dictionary/<l1>-<l2>.txt`` (`loader.py:665-684`)
        cand = os.path.join(cfg.data.data_path, "dictionary")
        paths_root = cand if os.path.isdir(cand) else ""
    if not paths_root:
        return None
    # --src_lgs / --ag_lgs restrict which source / augmentation-target
    # languages load (`loader.py:666-669`)
    src_filter = {l for l in cfg.src_lgs.split("-") if l}
    ag_filter = {l for l in cfg.ag_lgs.split("-") if l}
    lexicon: Dict = {}
    for path in glob.glob(os.path.join(paths_root, "*-*.txt")):
        name = os.path.splitext(os.path.basename(path))[0]
        src, tgt = name.split("-")[:2]
        if src_filter and src not in src_filter:
            continue
        if ag_filter and tgt not in ag_filter:
            continue
        load_bilingual_dict(path, src, tgt, lexicon)
    if not lexicon:
        return None
    return Clager(lexicon, cfg.data.mct_sent_ratio, cfg.data.mct_word_ratio)


def _dataset_root(cfg: TrainConfig, name: str,
                  overrides: Optional[Dict[str, str]] = None) -> str:
    """Per-dataset root: explicit path flags (--coco_path etc.,
    `train_x.py`) win over <features root>/<name>, where the features root
    is ``--input_fea_dir`` when given (the reference's feature-dir knob,
    `MILD_finetune.py:75`, `dataset_finetune.py`) else ``--data_path``."""
    if overrides and overrides.get(name):
        return overrides[name]
    base = getattr(cfg.data, "input_fea_dir", "") or cfg.data.data_path
    return os.path.join(base, name)


# Datasets whose shard schedule the reference opens UNCONDITIONALLY
# (`dataset_pretrain.py:91-96` reads {google,sbu}_train_order.json and
# hard-fails when absent).  For these a missing schedule under an explicitly
# given --train_order_path is an error, not a warning: a typo'd path would
# otherwise silently change shard order/composition.
_SCHEDULE_BEARING = frozenset({"google", "sbu"})


def _load_train_order(cfg: TrainConfig, name: str) -> Optional[List[List[int]]]:
    """``<train_order_path>/<name>_train_order.json``: epoch -> shard index
    per data-parallel feeder (`{google,sbu}_train_order.json`,
    `dataset_pretrain.py:210-226`)."""
    if not cfg.train_order_path:
        return None
    path = os.path.join(cfg.train_order_path, f"{name}_train_order.json")
    if not os.path.exists(path):
        if name in _SCHEDULE_BEARING:
            # reference semantics: the schedule for google/sbu is required
            # (dataset_pretrain.py:91-96); raise unless --allow_missing_data
            _data_missing(cfg, f"shard train-order schedule for '{name}' "
                          "(--train_order_path)", path)
            return None
        # other datasets legitimately ship no schedule — warn only
        logger.warning(
            "no shard train-order schedule for '%s' (%s) — shards iterate "
            "unscheduled", name, path)
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _captions_for(cfg: TrainConfig, root: str, name: str, split: str,
                  lang: str, store=None, warn: bool = True
                  ) -> Optional[Dict[str, List[str]]]:
    """Caption dict for (dataset, split, lang).

    Prefers this framework's per-split layout ``<root>/<split>.<lang>.pkl``;
    falls back to the reference layout — ONE pkl for every split under
    ``data_path/uvl_captions/<name>.<lang>.pkl`` (or ``<name>.pkl`` for en),
    `loader.py:275-281` — where split membership comes from the split's h5.
    When ``store`` is given, captions are restricted to images present in
    that split's feature store (required for the shared-pkl layout)."""
    caps = _load_captions(os.path.join(root, f"{split}.{lang}.pkl"),
                          warn=False)
    if caps is None:
        base = os.path.join(cfg.data.data_path, "uvl_captions")
        cands = [os.path.join(base, f"{name}.{lang}.pkl")]
        if lang == "en":
            cands.append(os.path.join(base, f"{name}.pkl"))
        for path in cands:
            if os.path.exists(path):
                caps = _load_captions(path)
                break
    if caps is None:
        if warn:
            logger.warning("captions not found: %s/%s.%s.pkl (and no "
                           "uvl_captions fallback)", root, split, lang)
        return None
    if store is not None:
        ids = set(store.image_ids)
        caps = {k: v for k, v in caps.items() if k in ids}
    return caps or None


def _cap_images(caps: Dict[str, List[str]], cfg: TrainConfig
                ) -> Dict[str, List[str]]:
    """--eval_images caps the retrieval test grid to the first N images
    (`dataset_finetune.py:961`); -1 keeps the full grid."""
    n = cfg.eval.eval_images
    if not n or n <= 0 or n >= len(caps):
        return caps
    keep = sorted(caps.keys())[:n]
    return {k: caps[k] for k in keep}


def _key(task: str, name: str, lang: str, multi: bool) -> Tuple[str, str]:
    """Dataset key; per-language suffix only in multi-language runs so
    single-language keys stay `(task, name)` (the common case)."""
    return (task, f"{name}:{lang}" if multi else name)


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------


def load_data(cfg: TrainConfig, cross_lingual_path: str = "",
              dataset_paths: Optional[Dict[str, str]] = None) -> LoadedData:
    """``dataset_paths``: optional {name: root} overrides (the reference's
    --coco_path/--flicker_path/--google_path/--sbu_path/--mild_path/
    --slide_path flags)."""
    out = LoadedData()
    tokenizer = _load_tokenizer(cfg)
    out.tokenizer = tokenizer
    if tokenizer is None:
        _data_missing(cfg, "tokenizer vocab", cfg.data.vocab_path)
        return out
    clager = _build_clager(cfg, cross_lingual_path
                           or cfg.data.cross_lingual_path)
    langs = cfg.ft_langs
    if cfg.ft_all and len(langs) > 1:
        # --ft_all: each data feeder fine-tunes a different language
        # (`loader.py:187-190,444-449`)
        langs = [langs[_process()[0] % len(langs)]]
    multi = len(langs) > 1
    # vocab ids come from the LOADED tokenizer, not the (possibly stale)
    # model config — the CLI rebuilds the model config from the tokenizer
    # only after load_data, and the noise transforms built here must use
    # the real <mask>/vocab ids (a 250001 mask id in a small vocab fed
    # out-of-range embedding lookups -> NaN training)
    n_words = getattr(tokenizer, "vocab_size", cfg.model.n_words)
    mask_index = getattr(tokenizer, "mask_token_id", cfg.model.mask_index)
    # --debug_train: valid data substitutes for train (`loader.py:374-375`)
    train_split = "valid" if cfg.debug_train else "train"
    # --eval_n caps validation set size per family (`xevaluator.py:485,1197`)
    n_eval = (max(1, -(-cfg.eval.eval_n // cfg.data.batch_size))
              if cfg.eval.eval_n > 0 else EVAL_BATCHES)
    # --split_data shards mono streams across data feeders
    # (`loader.py:409-413`); off = every feeder sees the full stream.  The
    # row loader would slice every source per process itself, so the
    # streams are sliced here for the `epoch_iterator` path only
    feed_kw: Dict[str, int] = {}
    if cfg.split_data and not cfg.data.use_grain:
        rank, world = _process()
        feed_kw = dict(n_feeders=world, feeder_id=rank)

    def eval_put(family: str, lang: str, value) -> None:
        key = f"{family}.{lang}" if multi else family
        out.eval_data[key] = value

    # ---- mono text streams: xMLM / CLM / MASS / BART / AE ------------
    stream_tasks: List[Tuple[str, str, Optional[Callable]]] = []
    for lang, _ in parse_steps(cfg.mlm_steps):
        stream_tasks.append(("mlm", lang, None))
        if cfg.is_generation:
            # `train_x.py:457-460`: is_generation drives bart_mlm +
            # bart_mass from mlm_steps; --use_noise word-noises the BART
            # source (`xtrainer.py:1617`)
            bart_noise = ((cfg.data.word_shuffle, cfg.data.word_dropout,
                           cfg.data.word_blank) if cfg.use_noise else None)
            stream_tasks.append(
                ("bart", lang, make_bart_transform(mask_index,
                                                   noise=bart_noise)))
            stream_tasks.append(
                ("mass", lang,
                 make_mass_transform(cfg.word_mass, mask_index, n_words)))
    for lang, _ in parse_steps(cfg.clm_steps):
        stream_tasks.append(("clm", lang, None))
    for lang, _ in parse_steps(cfg.mass_steps):
        stream_tasks.append(
            ("mass", lang,
             make_mass_transform(cfg.word_mass, mask_index, n_words)))
    for lang, _ in parse_steps(cfg.ae_steps):
        stream_tasks.append(
            ("ae", lang, make_ae_transform(
                max(cfg.data.word_shuffle, 2.0), cfg.data.word_dropout or 0.1,
                cfg.data.word_blank, mask_index)))

    seen_stream = set()
    for task, lang, transform in stream_tasks:
        if (task, lang) in seen_stream:
            continue
        seen_stream.add((task, lang))
        path = os.path.join(cfg.data.data_path, f"{train_split}.{lang}.npy")
        if not os.path.exists(path):
            _data_missing(cfg, f"mono stream for --{task}_steps {lang}",
                          path)
            continue
        stream = np.load(path)
        lang_id = cfg.lang2id.get(lang)
        if transform is None:
            out.train_datasets[(task, lang)] = StreamDataset(
                stream, bptt=cfg.data.bptt, seed=cfg.seed, **feed_kw)
        else:
            out.train_datasets[(task, lang)] = NoisedStreamDataset(
                stream, transform, lang_id=lang_id, bptt=cfg.data.bptt,
                seed=cfg.seed, **feed_kw)
        valid_path = os.path.join(cfg.data.data_path, f"valid.{lang}.npy")
        if os.path.exists(valid_path):
            ds = StreamDataset(np.load(valid_path), bptt=cfg.data.bptt)
            batches = list(ds.epoch_iterator(
                cfg.data.batch_size))[:n_eval]
            if task in ("mlm", "clm"):
                eval_put(f"{task}_batches", lang, batches)
            elif task == "mass":
                # deterministic eval masking (reference fixed eval RNG,
                # `xevaluator.py:402`)
                rng = np.random.RandomState(0)
                eval_put("mass_batches", lang,
                         [transform(rng, b, lang_id) for b in batches])

    # ---- parallel classification -------------------------------------
    for src, tgt in parse_steps(cfg.pc_steps):
        if tgt is None:
            continue
        pair = _load_parallel(cfg.data.data_path, train_split, src, tgt)
        if pair is None:
            _data_missing(
                cfg, f"parallel data for --pc_steps {src}-{tgt}",
                os.path.join(cfg.data.data_path,
                             f"{train_split}.{src}-{tgt}.*.txt"))
            continue
        out.train_datasets[("pc", src)] = PCDataset(
            pair[0], pair[1], tokenizer, max_len=cfg.data.max_len,
            seed=cfg.seed, src_lang_id=cfg.lang2id.get(src, 0),
            tgt_lang_id=cfg.lang2id.get(tgt, 1))

    # ---- retrieval / pretraining --------------------------------------
    for name, _mod in parse_steps(cfg.cross_rel_steps):
        root = _dataset_root(cfg, name, dataset_paths)
        h5s = sorted(glob.glob(os.path.join(root, "*.h5")))
        if not h5s:
            _data_missing(cfg, f"feature shards for --cross_rel_steps "
                          f"{name}", os.path.join(root, "*.h5"))
            continue
        stores = [RegionFeatureStore(p, cfg.data.max_region_num)
                  for p in h5s]

        def split_store(split: str, _h5s=h5s, _stores=stores):
            """Feature store for a split: `<split>*.h5` if present, else the
            first shard (single-shard layouts serve every split) — an
            alphabetical glob must never hand `test.h5` to the train loop."""
            for p, s in zip(_h5s, _stores):
                if os.path.basename(p).startswith(split):
                    return s
            return _stores[0]
        if cfg.is_pretrain:
            rank, world = _process()
            train_order = _load_train_order(cfg, name)
            if cfg.debug_pretrain:
                # --debug_pretrain pins h5 shard 0
                # (`dataset_pretrain.py:213-214`)
                h5s, stores, train_order = h5s[:1], stores[:1], None
            for lang in langs:
                caps = []
                for p in h5s:
                    cap_path = p.replace(".h5", f".{lang}.pkl")
                    caps.append(_load_captions(cap_path, warn=False) or {})
                if not any(caps):
                    _data_missing(
                        cfg, f"pretrain captions for '{name}' lang {lang}",
                        h5s[0].replace(".h5", f".{lang}.pkl"))
                    continue
                out.train_datasets[_key("rel", name, lang, multi)] = \
                    PretrainDataset(
                        stores, caps, tokenizer, train_order=train_order,
                        n_feeders=world, feeder_id=rank,
                        sample_n=cfg.data.sample_n, max_len=cfg.data.max_len,
                        clager=clager, lang=lang, seed=cfg.seed)
        elif cfg.is_mild or name == "mild":
            _load_mild(cfg, out, root, langs, multi, tokenizer, clager,
                       eval_put)
        else:
            for lang in langs:
                captions = _captions_for(cfg, root, name, train_split,
                                         lang, split_store(train_split),
                                         warn=False)
                if captions is None:
                    _data_missing(
                        cfg, f"retrieval captions for '{name}' lang {lang}",
                        os.path.join(root, f"{train_split}.{lang}.pkl"))
                    continue
                ds = RetrievalDataset(
                    captions, split_store(train_split), tokenizer, lang=lang,
                    sample_n=cfg.data.sample_n, max_len=cfg.data.max_len,
                    clager=clager, seed=cfg.seed)
                out.train_datasets[_key("rel", name, lang, multi)] = ds
                valid_caps = _captions_for(cfg, root, name, "valid", lang,
                                           split_store("valid"), warn=False)
                if valid_caps:
                    vds = RetrievalDataset(
                        valid_caps, split_store("valid"), tokenizer,
                        lang=lang, sample_n=cfg.data.sample_n,
                        max_len=cfg.data.max_len)
                    pairs = list(vds.epoch_iterator(
                        cfg.data.batch_size))[:n_eval]
                    # (t2i, i2t) pairs: the evaluator reports per-direction
                    # accs (the recipe's valid_T2I_acc / valid_I2T_acc)
                    eval_put("retrieval_valid_batches", lang, pairs)
                test_caps = _captions_for(cfg, root, name, "test", lang,
                                          split_store("test"))
                if test_caps:
                    eval_put("retrieval_test", lang,
                             build_eval_retrieval_arrays(
                                 _cap_images(test_caps, cfg),
                                 split_store("test"), tokenizer,
                                 max_len=cfg.data.max_len,
                                 caps_per_image=cfg.data.seq_per_img))

    # ---- captioning / TIFG / IDA(bart_img) -----------------------------
    # --is_mt repurposes cross_modal_steps for multimodal MT (the reference
    # loader dispatch is exclusive, `loader.py:686-703`)
    ic_steps = "" if cfg.is_mt else cfg.cross_ic_steps
    cap_like = ([("ic", n) for n, _ in parse_steps(ic_steps)]
                + [("tifg", n) for n, _ in parse_steps(cfg.tifg_steps)]
                + [("bart_img", n) for n, _ in
                   parse_steps(cfg.cross_ae_steps)])
    for task, name in cap_like:
        root = _dataset_root(cfg, name, dataset_paths)
        h5s = sorted(glob.glob(os.path.join(root, "*.h5")))
        if not h5s:
            _data_missing(cfg, f"feature shards for the {task} step on "
                          f"'{name}'", os.path.join(root, "*.h5"))
            continue
        # split-aware store choice (see split_store in the rel branch)
        def cap_store(split: str, _h5s=h5s):
            p = next((q for q in _h5s
                      if os.path.basename(q).startswith(split)), _h5s[0])
            return RegionFeatureStore(p, cfg.data.max_region_num)

        # follow --debug_train's split substitution (matches the rel branch)
        store = cap_store(train_split)
        for lang in langs:
            if cfg.is_pretrain and len(h5s) > 1:
                # sharded CC/SBU caption pre-training: the same per-epoch
                # shard schedule as the retrieval stream
                # (`VLMPretrainCapDataset`, `dataset_pretrain.py:507-784`)
                rank, world = _process()
                caps = [_load_captions(p.replace(".h5", f".{lang}.pkl"),
                                       warn=False) or {} for p in h5s]
                if not any(caps):
                    _data_missing(
                        cfg, f"pretrain captions for '{name}' lang {lang}",
                        h5s[0].replace(".h5", f".{lang}.pkl"))
                    continue
                stores = [RegionFeatureStore(p, cfg.data.max_region_num)
                          for p in h5s]
                out.train_datasets[_key(task, name, lang, multi)] = \
                    PretrainCaptionDataset(
                        stores, caps, tokenizer,
                        train_order=_load_train_order(cfg, name),
                        n_feeders=world, feeder_id=rank, lang=lang,
                        max_len=cfg.data.max_len, clager=clager,
                        seed=cfg.seed, region_noise=(task == "bart_img"),
                        lang_id=cfg.lang2id.get(lang))
                continue
            captions = _captions_for(cfg, root, name, train_split, lang,
                                     store, warn=False)
            if captions is None:
                _data_missing(
                    cfg, f"captions for the {task} step on '{name}' "
                    f"lang {lang}",
                    os.path.join(root, f"{train_split}.{lang}.pkl"))
                continue
            out.train_datasets[_key(task, name, lang, multi)] = \
                CaptionDataset(
                    captions, store, tokenizer, lang=lang,
                    max_len=cfg.data.max_len, clager=clager, seed=cfg.seed,
                    region_noise=(task == "bart_img"),
                    lang_id=cfg.lang2id.get(lang))
            if task != "ic":
                continue
            test_store = cap_store("test")
            test_caps = _captions_for(cfg, root, name, "test", lang,
                                      test_store, warn=False)
            if test_caps:
                # caption generation eval: decode each test image once,
                # score against all its reference captions
                # (`evaluate_image_caption`, `xevaluator.py:903-1117`)
                gen_ds = CaptionDataset(
                    {i: caps[:1] for i, caps in test_caps.items()},
                    test_store, tokenizer, lang=lang,
                    max_len=cfg.data.max_len)
                # drop_last=False: generation eval must decode EVERY
                # test image (a dropped remainder silently skips up to
                # bs-1 of them; the reference decodes all)
                batches = list(gen_ds.epoch_iterator(
                    cfg.eval.eval_batch_size, shuffle=False,
                    drop_last=False))
                img_order = [img_id for img_id, _ in gen_ds.items]
                eval_put("caption_gen", lang, {
                    "batches": batches,
                    "references": [test_caps[i] for i in img_order],
                    "image_ids": img_order,
                    "tokenizer": tokenizer,
                    "lang_id": cfg.lang2id.get(lang)})
            valid_store = cap_store("valid")
            valid_caps = _captions_for(cfg, root, name, "valid", lang,
                                       valid_store, warn=False)
            if valid_caps:
                vds = CaptionDataset(valid_caps, valid_store, tokenizer,
                                     lang=lang, max_len=cfg.data.max_len,
                                     lang_id=cfg.lang2id.get(lang))
                eval_put("caption_batches", lang, list(vds.epoch_iterator(
                    cfg.data.batch_size))[:n_eval])

    # ---- MT / NTG ------------------------------------------------------
    # NTG drives from text_steps under --is_ntg (`train_x.py:443-445`)
    ntg_steps = cfg.ntg_steps or (cfg.text_steps if cfg.is_ntg else "")
    step_groups = [("mt", cfg.cross_mt_steps), ("ntg", ntg_steps)]
    for kind, steps in step_groups:
        for src, tgt in parse_steps(steps):
            if tgt is None:
                continue
            pair = _load_parallel(cfg.data.data_path, train_split, src, tgt)
            if pair is None:
                _data_missing(
                    cfg, f"parallel data for the {kind} step {src}-{tgt}",
                    os.path.join(cfg.data.data_path,
                                 f"{train_split}.{src}-{tgt}.*.txt"))
                continue
            out.train_datasets[(kind, src)] = ParallelDataset(
                pair[0], pair[1], tokenizer, max_len=cfg.data.max_len,
                seed=cfg.seed, src_lang_id=cfg.lang2id.get(src),
                tgt_lang_id=cfg.lang2id.get(tgt),
                group_by_size=cfg.data.group_by_size)
            vpair = _load_parallel(cfg.data.data_path, "valid", src, tgt)
            if vpair:
                vds = ParallelDataset(
                    vpair[0], vpair[1], tokenizer, max_len=cfg.data.max_len,
                    src_lang_id=cfg.lang2id.get(src),
                    tgt_lang_id=cfg.lang2id.get(tgt))
                batches = list(vds.epoch_iterator(
                    cfg.data.batch_size, shuffle=False))[:n_eval]
                eval_put(f"{kind}_batches", src, batches)
                # generation eval against the raw target sentences
                # (`evaluate_mt`/`evaluate_ntg_generate`)
                n_refs = len(batches) * cfg.data.batch_size
                order = np.argsort([len(s) for s in vpair[0]],
                                   kind="stable")[:n_refs]
                eval_put(f"{kind}_gen", src, {
                    "batches": batches,
                    "references": [[vpair[1][i]] for i in order],
                    "tokenizer": tokenizer,
                    "lang_id": cfg.lang2id.get(tgt),
                    "name": kind})

    # ---- multimodal MT (`load_mt_data`, `MT_finetune.py:32-472`) -------
    # --is_mt + --cross_modal_steps <name>-img + --ft_lgs src-tgt; caption
    # pkls map image_id -> [src_caption, tgt_caption]
    # (`loader.py:346-347`, `MT_finetune.py:117-124`)
    if cfg.is_mt and len(cfg.ft_langs) >= 2:
        src_lg, tgt_lg = cfg.ft_langs[0], cfg.ft_langs[1]
        for name, _mod in parse_steps(cfg.cross_ic_steps):
            root = _dataset_root(cfg, name, dataset_paths)
            h5s = sorted(glob.glob(os.path.join(root, "*.h5")))
            if not h5s:
                _data_missing(cfg, f"feature shards for multimodal MT on "
                              f"'{name}'", os.path.join(root, "*.h5"))
                continue

            def mmt_store(split: str, _h5s=h5s):
                p = next((q for q in _h5s
                          if os.path.basename(q).startswith(split)), _h5s[0])
                return RegionFeatureStore(p, cfg.data.max_region_num)

            def load_pairs(split: str, _root=root, _name=name):
                caps = _load_captions(os.path.join(
                    _root, f"{split}.{src_lg}-{tgt_lg}.pkl"), warn=False)
                if caps is None:
                    caps = _load_captions(os.path.join(
                        cfg.data.data_path, "uvl_captions",
                        f"{_name}.{src_lg}-{tgt_lg}.pkl"), warn=False)
                return caps

            def mmt_dataset(pairs, store, shuffle_seed, group_by_size):
                store_ids = set(store.image_ids)
                ids = [i for i in pairs if i in store_ids]
                return ids, ParallelDataset(
                    [pairs[i][0] for i in ids],
                    [pairs[i][1] for i in ids],
                    tokenizer, max_len=cfg.data.max_len, seed=shuffle_seed,
                    src_lang_id=cfg.lang2id.get(src_lg),
                    tgt_lang_id=cfg.lang2id.get(tgt_lg),
                    store=store, image_ids=ids,
                    group_by_size=group_by_size)

            train_pairs = load_pairs(train_split)
            if not train_pairs:
                _data_missing(
                    cfg, f"multimodal-MT caption pairs for '{name}' "
                    f"{src_lg}-{tgt_lg}",
                    os.path.join(root, f"{train_split}.{src_lg}-{tgt_lg}.pkl"))
            if train_pairs:
                _, ds = mmt_dataset(train_pairs, mmt_store(train_split),
                                    cfg.seed, cfg.data.group_by_size)
                out.train_datasets[("mt", name)] = ds
            valid_pairs, valid_src = load_pairs("valid"), "valid"
            if valid_pairs is None:
                valid_pairs, valid_src = load_pairs("test"), "test"
            if valid_pairs:
                # the feature store must match the split that provided the
                # pairs, or the id intersection silently empties the eval
                vstore = mmt_store(valid_src)
                # length-sorted, unshuffled: the generation references below
                # rely on this order
                ids, vds = mmt_dataset(valid_pairs, vstore, 0, True)
                batches = list(vds.epoch_iterator(
                    cfg.data.batch_size, shuffle=False))[:n_eval]
                eval_put("mmt_batches", src_lg, batches)
                # generation references follow the length-sorted batch order
                n_refs = len(batches) * cfg.data.batch_size
                order = np.argsort([len(valid_pairs[i][0]) for i in ids],
                                   kind="stable")[:n_refs]
                eval_put("mmt_gen", src_lg, {
                    "batches": batches,
                    "references": [[valid_pairs[ids[j]][1]] for j in order],
                    "tokenizer": tokenizer,
                    "lang_id": cfg.lang2id.get(tgt_lg),
                    "name": "mmt"})

    # ---- slide ---------------------------------------------------------
    for name, _mod in parse_steps(cfg.slide_steps):
        root = _dataset_root(cfg, "slide", dataset_paths)
        h5s = sorted(glob.glob(os.path.join(root, "*.h5")))
        if not h5s:
            _data_missing(cfg, f"slide feature shards for --slide_steps "
                          f"{name}", os.path.join(root, "*.h5"))
            continue
        shared = RegionFeatureStore(h5s[0], cfg.data.max_region_num)
        for split in ("train", "test"):
            items_path = os.path.join(root, f"{split}.tsv")
            if not os.path.exists(items_path):
                continue
            split_h5 = next((p for p in h5s
                             if os.path.basename(p).startswith(split)), None)
            store = RegionFeatureStore(
                split_h5, cfg.data.max_region_num) if split_h5 else shared
            items = []
            with open(items_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 3:
                        items.append((parts[0], parts[1], int(parts[2])))
            ds = SlideDataset(items, store, tokenizer,
                              max_len=cfg.data.max_len, seed=cfg.seed)
            if split == "train":
                out.train_datasets[("slide", name)] = ds
            else:
                out.eval_data["slide_batches"] = list(ds.epoch_iterator(
                    cfg.data.batch_size))[:n_eval]

    logger.info("loaded %d train datasets (%s); eval keys: %s",
                len(out.train_datasets), sorted(out.train_datasets.keys()),
                sorted(out.eval_data.keys()))
    return out


def _load_mild(cfg, out, root, langs, multi, tokenizer, clager,
               eval_put) -> None:
    """MILD query-based retrieval: per-language feature h5s
    (``train.<lang>.h5``, `MILD_finetune.py:75`) with (query, passage) pkls;
    falls back to a shared shard when per-language files are absent.  Builds
    the caption-eval variant too (`MILDEvaluateCaptionDataset`,
    `MILD_finetune.py:944-974`)."""
    shared_h5s = sorted(set(glob.glob(os.path.join(root, "*.h5")))
                        - set(glob.glob(os.path.join(root, "*.*.h5"))))
    for lang in langs:
        lang_h5 = os.path.join(root, f"train.{lang}.h5")
        h5 = lang_h5 if os.path.exists(lang_h5) else \
            (shared_h5s[0] if shared_h5s else None)
        if h5 is None:
            continue
        store = RegionFeatureStore(h5, cfg.data.max_region_num)
        queries = _load_captions(os.path.join(root, f"train.{lang}.pkl"))
        if queries is None:
            continue
        out.train_datasets[_key("rel", "mild", lang, multi)] = MILDDataset(
            queries, store, tokenizer, qp_type=cfg.qp_type, lang=lang,
            sample_n=cfg.data.sample_n, max_len=cfg.data.max_len,
            clager=clager, seed=cfg.seed)
        test_h5 = os.path.join(root, f"test.{lang}.h5")
        test_store = RegionFeatureStore(test_h5, cfg.data.max_region_num) \
            if os.path.exists(test_h5) else store
        test_q = _load_captions(os.path.join(root, f"test.{lang}.pkl"),
                                warn=False)
        if test_q:
            mild_eval = MILDDataset(test_q, test_store, tokenizer,
                                    qp_type=cfg.qp_type, lang=lang)
            eval_put("retrieval_test", lang, build_eval_retrieval_arrays(
                _cap_images(mild_eval.captions, cfg), test_store, tokenizer,
                max_len=cfg.data.max_len, caps_per_image=1))
        # MILD caption eval: generate the passage from the image, CIDEr/BLEU
        cap_q = _load_captions(os.path.join(root, f"test.caption.{lang}.pkl"),
                               warn=False)
        if cap_q:
            gen_ds = CaptionDataset({i: c[:1] for i, c in cap_q.items()},
                                    test_store, tokenizer, lang=lang,
                                    max_len=cfg.data.max_len)
            img_order = [img_id for img_id, _ in gen_ds.items]
            eval_put("caption_gen", lang, {
                "batches": list(gen_ds.epoch_iterator(
                    cfg.eval.eval_batch_size, shuffle=False,
                    drop_last=False)),
                "references": [cap_q[i] for i in img_order],
                "image_ids": img_order,
                "tokenizer": tokenizer,
                "lang_id": cfg.lang2id.get(lang)})
