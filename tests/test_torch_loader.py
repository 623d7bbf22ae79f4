"""The port's `load_data` (m3p_tpu_torch.data.loader) against the JAX
package's over the same data directories: the same train dataset keys and
families, the same split stores (``test.h5`` never feeds the train loop),
bitwise equal batches, and the same eval families and payloads; the
layouts of `tests/test_cli.py` (per-split pkls, the ``uvl_captions``
fallback, MILD, slides, parallel text, streams, sharded pre-training,
multimodal MT) and a missing task with and without
``--allow_missing_data``."""

import itertools
import json
import logging
import os
import pickle

import numpy as np
import pytest

from m3p_tpu.cli import train_x as jax_cli
from m3p_tpu.data.loader import load_data as jax_load_data
from m3p_tpu.tokenization.unigram import train_unigram
from m3p_tpu_torch.cli import train_x
from m3p_tpu_torch.data.loader import load_data
from test_torch_datasets import WORDS, assert_same, sentences, write_shard

LEXICON = "red rot\ncat katze\ndog hund\nblue blau\n"


def _pkl(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _shard(root, name, ids, rng):
    write_shard(root / name, ids, rng)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Every layout of `tests/test_cli.py` under one data directory."""
    d = tmp_path_factory.mktemp("load")
    rng = np.random.RandomState(0)
    train_unigram(sentences(rng, 60, 6) + ["query passage"] * 10,
                  vocab_size=90).save(str(d / "vocab.tsv"))
    for split, n in (("train", 900), ("valid", 300)):
        for lang in ("en", "de"):
            np.save(d / f"{split}.{lang}.npy",
                    rng.randint(4, 80, n).astype(np.int32))
        for side, k in (("en", 5), ("de", 3)):
            (d / f"{split}.en-de.{side}.txt").write_text(
                "\n".join(sentences(rng, 9, k)) + "\n", encoding="utf-8")
    (d / "dictionary").mkdir()
    (d / "dictionary" / "en-de.txt").write_text(LEXICON, encoding="utf-8")

    def split_ids(prefix, splits=("train", "valid", "test"), n=(8, 6, 6)):
        return {s: [f"{prefix}{s}{k}" for k in range(m)]
                for s, m in zip(splits, n)}

    # coco: per-split shards and pkls in two languages
    coco = d / "coco"
    coco.mkdir()
    for split, ids in split_ids("c").items():
        _shard(coco, f"{split}.h5", ids, rng)
        for lang in ("en", "de"):
            _pkl(coco / f"{split}.{lang}.pkl",
                 {i: sentences(rng, 3) for i in ids})
    # flicker: the reference's one pkl for every split (uvl_captions)
    flicker = d / "flicker"
    flicker.mkdir()
    ids = split_ids("f", ("train", "test"), (8, 4))
    for split, group in ids.items():
        _shard(flicker, f"{split}.h5", group, rng)
    (d / "uvl_captions").mkdir()
    every = ids["train"] + ids["test"]
    _pkl(d / "uvl_captions" / "flicker.pkl",
         {i: sentences(rng, 2) for i in every})
    _pkl(d / "uvl_captions" / "flicker.de.pkl",
         {i: sentences(rng, 2) for i in every})
    # mild: per-language shards of (query, passage) pairs
    mild = d / "mild"
    mild.mkdir()
    for split, group in split_ids("m", ("train", "test"), (6, 6)).items():
        _shard(mild, f"{split}.en.h5", group, rng)
        _pkl(mild / f"{split}.en.pkl",
             {i: [(" ".join(rng.choice(WORDS, 3)) + " query",
                   " ".join(rng.choice(WORDS, 4)) + " passage")] * 2
              for i in group})
        if split == "test":
            _pkl(mild / "test.caption.en.pkl",
                 {i: sentences(rng, 2) for i in group})
    # slides: one shard, tab-separated items
    slide = d / "slide"
    slide.mkdir()
    sids = [f"s{k}" for k in range(10)]
    _shard(slide, "slides.h5", sids, rng)
    for split, group in (("train", sids[:6]), ("test", sids[6:])):
        (slide / f"{split}.tsv").write_text("".join(
            f"{i}\t{s}\t{k % 2}\n" for k, (i, s) in
            enumerate(zip(group, sentences(rng, len(group))))))
    # google: two pre-training shards and their schedule
    google = d / "google"
    google.mkdir()
    for k in range(2):
        group = [f"g{k}_{j}" for j in range(6)]
        _shard(google, f"train.{k}.h5", group, rng)
        _pkl(google / f"train.{k}.en.pkl",
             {i: sentences(rng, 2) for i in group})
    (d / "orders").mkdir()
    (d / "orders" / "google_train_order.json").write_text(
        json.dumps([[1], [0]]))
    # multi30k: multimodal MT pairs
    m30 = d / "multi30k"
    m30.mkdir()
    for split, group in split_ids("t", ("train", "test"), (8, 6)).items():
        _shard(m30, f"{split}.h5", group, rng)
        _pkl(m30 / f"{split}.en-de.pkl",
             {i: (sentences(rng, 1, 5)[0], sentences(rng, 1, 3)[0])
              for i in group})
    return d


COMMON = ["--max_region_num", "4", "--sample_n", "2", "--batch_size", "2",
          "--max_len", "12", "--bptt", "16"]
RECIPES = {
    "coco_every_family": [
        "--lgs", "en-de", "--ft_lgs", "en", "--src_lgs", "en",
        "--cross_rel_steps", "coco-img", "--cross_modal_steps", "coco-img",
        "--cross_gan_steps", "coco-img", "--cross_ae_steps", "coco-img",
        "--mlm_steps", "en,de", "--clm_steps", "en", "--mass_steps", "en",
        "--ae_steps", "en", "--pc_steps", "en-de", "--mt_steps", "en-de",
        "--eval_images", "4"],
    "coco_two_languages": [
        "--lgs", "en-de", "--ft_lgs", "en-de", "--cross_rel_steps",
        "coco-img", "--cross_modal_steps", "coco-img", "--eval_n", "2"],
    "uvl_captions": ["--lgs", "en-de", "--ft_lgs", "en-de",
                     "--cross_rel_steps", "flicker-img", "--seq_per_img",
                     "2"],
    "mild": ["--lgs", "en", "--is_mild", "True", "--cross_rel_steps",
             "mild-img", "--qp_type", "qp", "--eval_images", "3"],
    "slide": ["--lgs", "en", "--is_slide", "True", "--cross_rel_steps",
              "ppt"],
    "pretrain_shards": [
        "--lgs", "en", "--is_pretrain", "True", "--cross_rel_steps",
        "google-img", "--cross_modal_steps", "google-img",
        "--train_order_path", "{d}/orders", "--cross_lingual_path",
        "{d}/dictionary"],
    "multimodal_mt": ["--lgs", "en-de", "--ft_lgs", "en-de", "--is_mt",
                      "True", "--cross_modal_steps", "multi30k-img"],
    "generation_ntg": ["--lgs", "en-de", "--is_generation", "True",
                       "--use_noise", "0.1", "--mlm_steps", "en",
                       "--is_ntg", "True", "--mt_steps", "en-de"],
    "debug_train": ["--lgs", "en-de", "--debug_train", "True",
                    "--mlm_steps", "en", "--mt_steps", "en-de",
                    "--cross_rel_steps", "coco-img",
                    "--input_fea_dir", "{d}"],
}


def _configs(d, argv):
    argv = [a.replace("{d}", str(d)) for a in argv]
    argv = ["--data_path", str(d), "--vocab_path", str(d / "vocab.tsv"),
            "--mild_path", str(d / "mild"), "--google_path",
            str(d / "google")] + COMMON + argv
    jargs = jax_cli.get_parser().parse_args(argv)
    paths = {"coco": jargs.coco_path, "flicker": jargs.flicker_path,
             "google": jargs.google_path, "sbu": jargs.sbu_path,
             "mild": jargs.mild_path, "slide": jargs.slide_path}
    return (train_x.args_to_config(train_x.get_parser().parse_args(argv)),
            jax_cli.args_to_config(jargs), paths)


def _stores(ds):
    """The shard paths a dataset reads."""
    out = [s.path for s in getattr(ds, "shards", [])]
    store = getattr(ds, "store", None)
    return out + ([store.path] if store is not None else [])


def _payload_same(got, want, where):
    if isinstance(want, dict) and "tokenizer" in want:
        assert got.keys() == want.keys(), where
        assert type(got["tokenizer"]).__name__ == "XLMRTokenizer"
        got = {k: v for k, v in got.items() if k != "tokenizer"}
        want = {k: v for k, v in want.items() if k != "tokenizer"}
    assert_same(got, want, where)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_load_data_matches_jax(data_dir, recipe):
    pcfg, jcfg, paths = _configs(data_dir, RECIPES[recipe])
    got = load_data(pcfg, dataset_paths=paths)
    want = jax_load_data(jcfg, dataset_paths=paths)
    assert got.tokenizer.vocab_size == want.tokenizer.vocab_size
    assert sorted(got.train_datasets) == sorted(want.train_datasets)
    assert got.train_datasets, recipe
    for key, jds in want.train_datasets.items():
        pds = got.train_datasets[key]
        assert type(pds).__name__ == type(jds).__name__, key
        assert _stores(pds) == _stores(jds), key
        assert not any(os.path.basename(p).startswith("test")
                       for p in _stores(pds)), key
        kw = {"with_clcm": True} if type(jds).__name__ == \
            "PretrainDataset" else {}
        for epoch in (0, 1):
            assert_same(list(itertools.islice(
                            pds.epoch_iterator(2, epoch, **kw), 3)),
                        list(itertools.islice(
                            jds.epoch_iterator(2, epoch, **kw), 3)),
                        f"{recipe} {key} epoch {epoch}")
    assert sorted(got.eval_data) == sorted(want.eval_data)
    for key in want.eval_data:
        _payload_same(got.eval_data[key], want.eval_data[key],
                      f"{recipe} {key}")


def test_missing_task_raises_or_is_skipped_as_in_jax(data_dir):
    typo = ["--lgs", "en", "--mlm_steps", "en", "--cross_rel_steps",
            "coco-img", "--coco_path", str(data_dir / "cocoo")]
    for argv in (typo, ["--lgs", "fr", "--mlm_steps", "fr"],
                 ["--lgs", "en", "--pc_steps", "en-fr"]):
        pcfg, jcfg, paths = _configs(data_dir, argv)
        with pytest.raises(FileNotFoundError) as want:
            jax_load_data(jcfg, dataset_paths=paths)
        with pytest.raises(FileNotFoundError) as got:
            load_data(pcfg, dataset_paths=paths)
        assert str(got.value) == str(want.value)
    pcfg, jcfg, paths = _configs(data_dir, typo + ["--allow_missing_data",
                                                   "True"])
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("m3p_tpu_torch")
    logger.addHandler(handler)
    try:
        got = load_data(pcfg, dataset_paths=paths)
    finally:
        logger.removeHandler(handler)
    want = jax_load_data(jcfg, dataset_paths=paths)
    assert sorted(got.train_datasets) == sorted(want.train_datasets) == \
        [("mlm", "en")]
    assert any("cocoo" in r.getMessage() for r in records)
    # no vocab: nothing loads
    pcfg, _, paths = _configs(data_dir, ["--lgs", "en", "--mlm_steps", "en",
                                         "--vocab_path", "/nonexistent.tsv"])
    with pytest.raises(FileNotFoundError, match="nonexistent.tsv"):
        load_data(pcfg, dataset_paths=paths)
