"""The port's tokenization stack against the JAX package's: the native C++
encoder (built from `m3p_tpu_torch/csrc/` into `build/`) and the
pure-Python model give the JAX tokenizer's ids on a TSV and on a
SentencePiece protobuf, also after a pickle round trip; the Python and the
native trainers write the JAX trainers' TSVs byte for byte; the legacy
`Dictionary`; and the three subcommands of `cli/preprocess.py` write the
JAX CLI's files.  All comparisons are exact."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from m3p_tpu.cli import preprocess as jax_preprocess
from m3p_tpu.tokenization.dictionary import Dictionary as JaxDictionary
from m3p_tpu.tokenization.spm_reader import write_spm as jax_write_spm
from m3p_tpu.tokenization.tokenizer import XLMRTokenizer as JaxTokenizer
from m3p_tpu.tokenization.unigram import train_unigram as jax_train_unigram
from m3p_tpu_torch.cli import preprocess
from m3p_tpu_torch.ops import _build
from m3p_tpu_torch.tokenization import native
from m3p_tpu_torch.tokenization.dictionary import Dictionary
from m3p_tpu_torch.tokenization.spm_reader import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, serialize_spm, write_spm)
from m3p_tpu_torch.tokenization.tokenizer import (
    ENCODE_MAX_IDS, XLMRTokenizer, _tsv_for_native)
from m3p_tpu_torch.tokenization.unigram import UnigramModel, train_unigram

REPO = Path(__file__).resolve().parents[1]

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the quick brown fox was quicker than the lazy dog",
    "ein schneller brauner fuchs springt über den faulen hund",
    "le renard brun rapide saute par-dessus le chien paresseux",
    "машинное обучение работает",
    "the dog and the fox and the quick brown fox",
    "縮小模型 詞表 訓練",
    "unigram language model training with expectation maximization",
    "subword segmentation maximizes the sum of piece log probabilities",
] * 3
HELD_OUT = [
    "the lazy fox trains a quick unigram model",
    "обучение сегментация 訓練 mixed-script sentence",
    "completely unseen wörter überall",
    "Ünïcödé\tcontrol​space  and   runs  ",
    "",
    " ".join(["quick"] * 700),
]
# the XLM-R layout of a converted .spm: <unk>, <s>, </s> at raw ids 0-2
SPM_PIECES = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
              ("</s>", 0.0, TYPE_CONTROL), ("▁hello", -1.0, TYPE_NORMAL),
              ("▁world", -1.5, TYPE_NORMAL), ("▁he", -3.0, TYPE_NORMAL),
              ("llo", -3.5, TYPE_NORMAL), ("▁", -4.0, TYPE_NORMAL)] + [
    (c, -5.0 - 0.1 * i, TYPE_NORMAL) for i, c in enumerate("helowrds<>/")]


@pytest.fixture(scope="module")
def tsv_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_tok") / "unigram.tsv")
    train_unigram(CORPUS, vocab_size=200).save(path)
    return path


@pytest.fixture(scope="module")
def spm_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_spm") / "xlmr.spm")
    write_spm(path, *map(list, zip(*SPM_PIECES)))
    return path


def _corpus_file(tmp_path, lines=CORPUS, name="corpus.txt"):
    path = tmp_path / name
    path.write_text("\n".join(lines), encoding="utf-8")
    return str(path)


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------


def test_library_is_built_from_the_port_sources_into_build():
    lib = native.load_library()
    path = _build.host_library_path("m3ptok", native.SOURCES)
    assert path.parent == REPO / "build" and path.exists()
    assert lib is native.load_library()
    assert not any("native/libm3ptok" in str(p) for p in (path,))


def test_a_failed_build_raises_with_the_compilers_stderr(tmp_path,
                                                         monkeypatch):
    """No quiet fallback: a source that does not compile raises
    RuntimeError carrying the compiler's message."""
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        _build.build_host("broken", ["broken.cpp"])
    assert list((tmp_path / "build").iterdir()) == []


def test_a_tokenizer_without_a_native_library_raises(tsv_path, monkeypatch):
    def no_library(name, sources):
        raise RuntimeError("the host compiler failed")

    monkeypatch.setattr(_build, "load_host", no_library)
    with pytest.raises(RuntimeError, match="host compiler"):
        XLMRTokenizer(tsv_path)
    assert XLMRTokenizer(tsv_path, use_native=False).encode("the fox")


# ---------------------------------------------------------------------------
# ids: native == Python == JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["tsv", "spm"])
def test_native_and_python_ids_equal_the_jax_tokenizers(which, tsv_path,
                                                       spm_path):
    path = tsv_path if which == "tsv" else spm_path
    nat, py = XLMRTokenizer(path), XLMRTokenizer(path, use_native=False)
    want = JaxTokenizer(path, use_native=False)
    assert nat._native is not None and py._native is None
    texts = CORPUS[:9] + HELD_OUT + ["hello world", "hello <s> </s> worlds"]
    for t in texts:
        ids = want.encode(t)[:ENCODE_MAX_IDS]
        assert nat.encode(t) == ids, t
        assert py.encode(t) == ids, t
    for max_ids in (6, 256):
        expect = [ids[:max_ids] for ids in
                  (want.encode(t) for t in texts)]
        assert nat.encode_batch(texts, max_ids=max_ids) == expect
        assert py.encode_batch(texts, max_ids=max_ids) == expect
    for tok in (nat, py):
        assert tok.vocab_size == want.vocab_size
        assert tok.mask_token_id == want.mask_token_id
        ids = tok.encode(texts[0])
        assert tok.decode(ids) == want.decode(ids)


@pytest.mark.parametrize("n_threads", [0, 1, 3])
def test_encode_batch_gives_the_same_ids_on_any_number_of_threads(
        tsv_path, n_threads):
    """Up to `TEXTS_PER_THREAD` texts encode on the calling thread, more
    over native threads; the ids are the Python model's either way."""
    texts = (CORPUS + HELD_OUT[:4]) * 10
    model = UnigramModel.load(tsv_path)
    want = [model.encode(t)[:7] for t in texts]
    enc = native.NativeUnigram(tsv_path)
    assert len(texts) > 2 * native.TEXTS_PER_THREAD
    assert enc.encode_batch(texts, max_ids=7, n_threads=n_threads) == want
    assert enc.encode_batch(texts[:3], max_ids=7,
                            n_threads=n_threads) == want[:3]


def test_native_encode_cuts_at_4096_ids(tsv_path):
    text = " ".join(["quick"] * 5000)
    nat, py = XLMRTokenizer(tsv_path), XLMRTokenizer(tsv_path,
                                                     use_native=False)
    assert len(UnigramModel.load(tsv_path).encode(text)) > ENCODE_MAX_IDS
    assert nat.encode(text) == py.encode(text)
    assert len(nat.encode(text)) == ENCODE_MAX_IDS


def test_pickle_round_trip_reloads_the_native_encoder(spm_path):
    tok = XLMRTokenizer(spm_path)
    back = pickle.loads(pickle.dumps(tok))
    assert back._native is not None and back._native is not tok._native
    assert back.encode("hello world") == tok.encode("hello world")
    enc = pickle.loads(pickle.dumps(tok._native))
    assert enc.encode("▁hello") == tok._native.encode("▁hello")
    assert len(enc) == len(SPM_PIECES)
    assert enc.id_to_piece(3) == "▁hello" and enc.piece_to_id("llo") == 6


def test_spm_is_converted_once_to_a_cached_tsv(spm_path):
    model = UnigramModel.load(spm_path)
    cache = _tsv_for_native(spm_path, model)
    assert cache == spm_path + ".tsv"
    assert UnigramModel.load(cache).pieces == model.pieces
    mtime = os.path.getmtime(cache)
    assert _tsv_for_native(spm_path, model) == cache
    assert os.path.getmtime(cache) == mtime


def test_spm_writer_equals_the_jax_writers_bytes(tmp_path):
    pieces, scores, types = map(list, zip(*SPM_PIECES))
    jax_write_spm(str(tmp_path / "jax.spm"), pieces, scores, types)
    assert (tmp_path / "jax.spm").read_bytes() == serialize_spm(
        pieces, scores, types)


# ---------------------------------------------------------------------------
# vocab training
# ---------------------------------------------------------------------------


def test_python_trainer_writes_the_jax_tsv(tmp_path):
    train_unigram(iter(CORPUS), vocab_size=150).save(str(tmp_path / "a"))
    jax_train_unigram(iter(CORPUS), vocab_size=150).save(str(tmp_path / "b"))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_native_trainer_writes_the_jax_native_trainers_tsv(tmp_path):
    """The native TSV (scores as %.17g) equals, byte for byte, the JAX
    Python trainer's model written that way, which the JAX native trainer
    writes; the port's Python trainer gives the same model."""
    corpus = _corpus_file(tmp_path)
    out = str(tmp_path / "native.tsv")
    n = native.native_train_unigram([corpus], out, vocab_size=200)
    want = jax_train_unigram(iter(CORPUS), vocab_size=200)
    assert n == len(want)
    text = "".join(f"{p}\t{s:.17g}\n" for p, s in zip(want.pieces,
                                                       want.scores))
    assert Path(out).read_text(encoding="utf-8") == text
    mine = train_unigram(iter(CORPUS), vocab_size=200)
    assert mine.pieces == want.pieces and mine.scores == want.scores


def test_native_trainer_raises_on_an_unwritable_output(tmp_path):
    corpus = _corpus_file(tmp_path)
    with pytest.raises(OSError):
        native.native_train_unigram([corpus], str(tmp_path / "no" / "x.tsv"),
                                    vocab_size=50)


# ---------------------------------------------------------------------------
# the legacy dictionary
# ---------------------------------------------------------------------------


def test_dictionary_equals_the_jax_dictionary(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("the 50\nfox 20\nthe 3\ndog 9\nlazy 2\nquick\n",
                     encoding="utf-8")
    text = _corpus_file(tmp_path, ["the quick fox", "", "a lazy dog ran"])
    for kw in ({}, {"max_vocab": 2}, {"min_count": 5}):
        mine = Dictionary.read_vocab(str(vocab), **kw)
        want = JaxDictionary.read_vocab(str(vocab), **kw)
        assert mine.word2id == want.word2id and mine.counts == want.counts
        got = mine.index_data(text, str(tmp_path / "mine.npz"))
        ref = want.index_data(text, str(tmp_path / "jax.npz"))
        for key in ("sentences", "positions"):
            np.testing.assert_array_equal(got[key], ref[key])
            assert got[key].dtype == ref[key].dtype
        assert got["unk_words"] == ref["unk_words"]
        with np.load(tmp_path / "mine.npz") as a, \
                np.load(tmp_path / "jax.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError):
        Dictionary({0: "<s>"}, {"<s>": 0})


# ---------------------------------------------------------------------------
# cli/preprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "native", "python"])
def test_train_vocab_writes_the_jax_clis_file(impl, tmp_path):
    corpus = _corpus_file(tmp_path)
    mine, want = str(tmp_path / "mine.tsv"), str(tmp_path / "jax.tsv")
    preprocess.main(["train-vocab", corpus, "--out", mine, "--size", "120",
                     "--impl", impl])
    if impl == "python":
        jax_preprocess.main(["train-vocab", corpus, "--out", want,
                             "--size", "120", "--impl", "python"])
    else:
        model = jax_train_unigram(iter(CORPUS), vocab_size=120)
        Path(want).write_text("".join(
            f"{p}\t{s:.17g}\n" for p, s in zip(model.pieces, model.scores)),
            encoding="utf-8")
    assert Path(mine).read_bytes() == Path(want).read_bytes()


def test_binarize_writes_the_jax_clis_stream(tmp_path, tsv_path):
    a = _corpus_file(tmp_path, CORPUS[:5] + ["", "zebra quokka"], "a.txt")
    b = _corpus_file(tmp_path, HELD_OUT, "b.txt")
    mine, want = str(tmp_path / "mine.npy"), str(tmp_path / "jax.npy")
    preprocess.main(["binarize", a, b, "--vocab", tsv_path, "--out", mine])
    jax_preprocess.main(["binarize", a, b, "--vocab", tsv_path, "--out",
                         want])
    got, ref = np.load(mine), np.load(want)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert Path(mine).read_bytes() == Path(want).read_bytes()


def test_spm_to_tsv_round_trips_a_write_spm_file(tmp_path, spm_path):
    mine, want = str(tmp_path / "mine.tsv"), str(tmp_path / "jax.tsv")
    preprocess.main(["spm-to-tsv", spm_path, "--out", mine])
    jax_preprocess.main(["spm-to-tsv", spm_path, "--out", want])
    assert Path(mine).read_bytes() == Path(want).read_bytes()
    back = UnigramModel.load(mine)
    spm = UnigramModel.load(spm_path)
    assert (back.pieces, back.scores, back.types) == (
        spm.pieces, spm.scores, spm.types)
    stream = str(tmp_path / "s.npy")
    text = _corpus_file(tmp_path, ["hello world", "hello"], "h.txt")
    preprocess.main(["binarize", text, "--vocab", mine, "--out", stream])
    tok = XLMRTokenizer(spm_path)
    want_ids = tok.encode("hello world") + [2] + tok.encode("hello") + [2]
    assert np.load(stream).tolist() == want_ids


def test_preprocess_runs_as_a_module(tmp_path):
    corpus = _corpus_file(tmp_path)
    out = str(tmp_path / "v.tsv")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "m3p_tpu_torch.cli.preprocess",
         "train-vocab", corpus, "--out", out, "--size", "80"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "(native)" in proc.stdout and len(UnigramModel.load(out)) > 0
