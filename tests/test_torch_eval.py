"""The port's evaluation layer against the JAX package's, on
`small_test_config()` in fp32 (2 layers, 64d, 4 heads, 8 regions) with a
small unigram vocab, the weights moved over by `params_from_jax`: the
config dataclasses and presets, the four caption metrics and R@k (equal),
the full-grid scorer (atol 1e-5, with and without length buckets and
across two processes), its progress log, and the `Evaluator` family by
family through `run_all_evals` (rtol 1e-4; decoded strings and their
BLEU / CIDEr equal).

The word head's EOS bias is raised by ``EOS_BIAS`` in both frameworks so
that hypotheses end at different lengths.  The port draws its eval masks
from torch generators, which cannot give JAX's, so the MLM family is held
with JAX's masking for ``PRNGKey(0)`` fed to the port's ``mask_tokens`` by
monkeypatch."""

import dataclasses
import itertools
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu import config as jconfig
from m3p_tpu.data import masking as jmasking
from m3p_tpu.eval import caption_metrics as jcm
from m3p_tpu.eval.bleu import corpus_bleu as jbleu
from m3p_tpu.eval.cider import cider_score as jcider
from m3p_tpu.eval.evaluator import Evaluator as JaxEvaluator
from m3p_tpu.eval.retrieval import recall_at_k as jrecall
from m3p_tpu.eval.retrieval import retrieval_grid_scores as jgrid
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.tokenization.tokenizer import XLMRTokenizer as JaxTokenizer
from m3p_tpu.tokenization.unigram import train_unigram
from m3p_tpu_torch import bench_eval_grid
from m3p_tpu_torch import config as tconfig
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.config import EOS_IDX
from m3p_tpu_torch.data import synthetic
from m3p_tpu_torch.data.span_masking import mass_mask
from m3p_tpu_torch.eval import caption_metrics as tcm
from m3p_tpu_torch.eval import retrieval as R
from m3p_tpu_torch.eval.bleu import corpus_bleu as tbleu
from m3p_tpu_torch.eval.cider import cider_score as tcider
from m3p_tpu_torch.eval.evaluator import EVAL_SEED, Evaluator
from m3p_tpu_torch.model import build_model, q8_collection
from m3p_tpu_torch.train import steps as tsteps
from test_eval import GOLDEN_HYPS, GOLDEN_REFS

torch.set_num_threads(1)

RTOL = 1e-4
GRID_ATOL = 1e-5
EOS_BIAS = 1.0
REGIONS = 8
GEN_LEN = 8
CORPUS = [
    "a dog runs on the beach", "two cats sleep on the sofa",
    "a man rides a bicycle", "the quick brown fox jumps",
    "a red car on the street", "children play in the snow",
] * 5
CONFIG_CLASSES = ["OptimConfig", "MeshConfig", "DataConfig", "EvalConfig",
                  "TrainConfig"]
PRESETS = ["scale_up_config", "long_context_config", "small_test_config"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_matches_jax(name):
    got, want = getattr(tconfig, name), getattr(jconfig, name)
    assert [n for n, _ in _fields(got)] == [n for n, _ in _fields(want)]
    for (n, a), (_, b) in zip(_fields(got), _fields(want)):
        assert (dataclasses.asdict(a) if dataclasses.is_dataclass(a)
                else a) == (dataclasses.asdict(b)
                            if dataclasses.is_dataclass(b) else b), n
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


@pytest.mark.parametrize("name", PRESETS)
def test_config_preset_matches_jax(name):
    got, want = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    assert (got.lang2id, got.id2lang, got.ft_langs) == (
        want.lang2id, want.id2lang, want.ft_langs)
    tuned = dict(ft_lgs="de-en", exp_id="x")
    assert got.replace(**tuned).ft_langs == want.replace(**tuned).ft_langs
    assert hash(got.model) == hash(tconfig.ModelConfig(
        **dataclasses.asdict(got.model)))


def test_small_test_config_overrides_match_jax():
    kw = dict(n_layers=1, sample_n=3, epoch_size=7)
    assert dataclasses.asdict(tconfig.small_test_config(**kw)) == \
        dataclasses.asdict(jconfig.small_test_config(**kw))
    with pytest.raises(AttributeError):
        tconfig.small_test_config(no_such_field=1)


# ---------------------------------------------------------------------------
# caption metrics and R@k
# ---------------------------------------------------------------------------

METRICS = {
    "bleu": (tbleu, jbleu),
    "cider": (tcider, jcider),
    "rouge_l": (tcm.rouge_l_score, jcm.rouge_l_score),
    "meteor": (tcm.meteor_score, jcm.meteor_score),
}


def _random_corpus(seed, n=40):
    rng = np.random.RandomState(seed)
    words = ("a the dog dogs cat running runs sat sitting on in red blue "
             "man men woman women bike bikes street streets").split()

    def sent():
        return " ".join(rng.choice(words, rng.randint(1, 12)))
    hyps = [sent() for _ in range(n)]
    refs = [[sent() for _ in range(rng.randint(1, 5))] for _ in range(n)]
    return hyps, refs


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_caption_metric_equals_jax(metric):
    got_fn, want_fn = METRICS[metric]
    corpora = [(GOLDEN_HYPS, GOLDEN_REFS),
               ([r[0] for r in GOLDEN_REFS], GOLDEN_REFS),
               _random_corpus(0), _random_corpus(1)]
    for hyps, refs in corpora:
        assert got_fn(hyps, refs) == want_fn(hyps, refs)


def test_recall_at_k_equals_jax_ties_included():
    rng = np.random.RandomState(3)
    cap_to_img = np.repeat(np.arange(7), 3)
    for scores in (rng.randn(7, 21).astype(np.float32),
                   rng.randint(0, 3, (7, 21)).astype(np.float32),
                   np.zeros((7, 21), np.float32)):
        assert R.recall_at_k(scores, cap_to_img) == jrecall(scores,
                                                            cap_to_img)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _with_eos_bias(params):
    bias = np.array(params["pred_layer"]["bias"])
    bias[EOS_IDX] += EOS_BIAS
    return {**params, "pred_layer": {**params["pred_layer"], "bias": bias}}


def _cfg(module, vocab, **eval_kw):
    cfg = module.small_test_config(n_words=vocab.vocab_size,
                                   mask_index=vocab.mask_token_id)
    ev = dict(beam_size=3, max_gen_len=GEN_LEN,
              coco_method="Bleu,METEOR,ROUGE_L,CIDEr", **eval_kw)
    return cfg.replace(eval=dataclasses.replace(cfg.eval, **ev))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """JAX model and parameters (EOS-biased), the port's model with the
    same weights, both tokenizers over one unigram vocab, and the two
    evaluators."""
    path = str(tmp_path_factory.mktemp("torch_eval_tok") / "unigram.tsv")
    train_unigram(CORPUS, vocab_size=150).save(path)
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    jtok, ttok = JaxTokenizer(path), XLMRTokenizer(path)
    jcfg, tcfg = _cfg(jconfig, jtok), _cfg(tconfig, jtok)
    jm, params = jax_build_model(jcfg.model, jax.random.PRNGKey(0))
    params = _with_eos_bias(jax.tree.map(np.asarray, params))
    model = build_model(tconfig.ModelConfig(**dataclasses.asdict(
        jcfg.model)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return {"jm": jm, "params": params, "model": model, "jcfg": jcfg,
            "tcfg": tcfg, "jtok": jtok, "ttok": ttok,
            "jev": JaxEvaluator(jm, jcfg), "tev": Evaluator(model, tcfg)}


def _pool(seed, n_img=6, n_cap=13, s=16, n_words=40):
    """A test grid: captions of ids below ``n_words`` (within every vocab
    here), images with padded regions."""
    rng = np.random.RandomState(seed)
    cap_len = rng.randint(3, s + 1, (n_cap,)).astype(np.int32)
    cap_tokens = np.ones((n_cap, s), np.int32)
    for i, n in enumerate(cap_len):
        cap_tokens[i, 0] = 0
        cap_tokens[i, 1:n] = rng.randint(4, n_words - 1, n - 1)
    feats = rng.randn(n_img, REGIONS, 2048).astype(np.float32)
    locs = rng.rand(n_img, REGIONS, 5).astype(np.float32)
    img_len = rng.randint(3, REGIONS + 1, (n_img,)).astype(np.int32)
    return cap_tokens, cap_len, feats, locs, img_len


# ---------------------------------------------------------------------------
# the full-grid scorer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["whole", "buckets", "two_processes"])
def test_retrieval_grid_scores_match_jax(small, case):
    pool = _pool(1)
    kw = dict(chunk_size=5, refine_image=True)
    if case == "buckets":
        kw.update(length_bucket=True, min_bucket=4)
    if case != "two_processes":
        got = R.retrieval_grid_scores(small["model"], *pool, **kw)
        want = jgrid(small["jm"], small["params"], *pool, **kw)
        assert got.dtype == np.float32 and got.shape == (6, 13)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=GRID_ATOL)
        return
    whole = R.retrieval_grid_scores(small["model"], *pool, **kw)
    parts = []
    for pi in range(2):
        got = R.retrieval_grid_scores(small["model"], *pool, **kw,
                                      process_index=pi, process_count=2)
        want = np.asarray(jgrid(small["jm"], small["params"], *pool, **kw,
                                process_index=pi, process_count=2))
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRID_ATOL)
        assert 0 < np.count_nonzero(got) < got.size
        parts.append(got)
    assert not ((parts[0] != 0) & (parts[1] != 0)).any()
    np.testing.assert_allclose(parts[0] + parts[1], whole, rtol=0,
                               atol=GRID_ATOL)


def test_retrieval_grid_refuses_a_mesh_argument(small):
    """A batch sharding is taken, no longer refused: a port process drives
    one card, so it shares the chunks out over the batch shards, as
    ``process_index`` / ``process_count`` do."""
    from m3p_tpu_torch.parallel.sharding import BatchSharding

    pool = _pool(2)
    for index in range(2):
        got = R.retrieval_grid_scores(small["model"], *pool, chunk_size=16,
                                      batch_sharding=BatchSharding(index, 2))
        want = R.retrieval_grid_scores(small["model"], *pool, chunk_size=16,
                                       process_index=index, process_count=2)
        np.testing.assert_array_equal(got, want)
        assert 0 < np.count_nonzero(got) < got.size


def test_retrieval_grid_progress_logging(small, monkeypatch):
    """Progress lines come from the host copy loop once 60 s have passed
    (a fake clock advancing 61 s a reading), and a small grid on the real
    clock stays silent.  A direct handler, not caplog, as in
    `tests/test_eval.py`."""
    pool = _pool(3, n_img=3, n_cap=4, s=10)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    lg = logging.getLogger("m3p_tpu_torch.eval.retrieval")
    prev_level = lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        fake = itertools.count(step=61.0)
        monkeypatch.setattr(R.time, "perf_counter",
                            lambda: float(next(fake)))
        grid = R.retrieval_grid_scores(small["model"], *pool, chunk_size=5,
                                       refine_image=False)
        assert grid.shape == (3, 4)
        prog = [r for r in records if "grid eval:" in r.getMessage()]
        assert prog, "no progress lines on a multi-chunk grid, slow clock"
        assert "pairs/s" in prog[0].getMessage()
        assert "3/3 chunks" in prog[-1].getMessage()
        monkeypatch.undo()
        records.clear()
        R.retrieval_grid_scores(small["model"], *pool, chunk_size=5,
                                refine_image=False)
        assert not [r for r in records if "grid eval:" in r.getMessage()]
    finally:
        lg.removeHandler(handler)
        lg.setLevel(prev_level)


def test_merge_process_scores(monkeypatch):
    """The identity in one process; over several ranks the all-reduced sum
    of the partial matrices (a fake second rank holding the same partial
    here; `tests/test_torch_parallel.py` runs two real ranks)."""
    scores = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert R.merge_process_scores(scores) is scores
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, op=None: t.mul_(2))
    np.testing.assert_array_equal(R.merge_process_scores(scores),
                                  2 * scores)


# ---------------------------------------------------------------------------
# the Evaluator, family by family
# ---------------------------------------------------------------------------


def _images(rng, b):
    return {"feats": rng.randn(b, REGIONS, 2048).astype(np.float32),
            "locs": rng.rand(b, REGIONS, 5).astype(np.float32),
            "img_len": rng.randint(3, REGIONS + 1, (b,)).astype(np.int32)}


def _family_data(family, n_words, mask_index):
    rng = np.random.RandomState(sorted(FAMILIES).index(family))
    if family in ("mlm", "clm"):
        return [synthetic.make_stream_batch(rng, 3, 12, n_words)
                for _ in range(2)]
    if family == "mass":
        out = []
        for _ in range(2):
            s = synthetic.make_stream_batch(rng, 3, 12, n_words)
            out.append(mass_mask(rng, s["tokens"], s["lengths"], 0.5,
                                 mask_index, n_words))
        return out
    if family in ("mt", "ntg"):
        return [synthetic.make_mt_batch(rng, 3, 10, n_words)
                for _ in range(2)]
    if family == "mmt":
        return [{**synthetic.make_mt_batch(rng, 3, 10, n_words),
                 **_images(rng, 3)} for _ in range(2)]
    if family == "caption":
        return [{**synthetic.make_caption_batch(rng, 3, 10, REGIONS,
                                                n_words), **_images(rng, 3)}
                for _ in range(2)]
    if family == "slide":
        return [{**synthetic.make_slide_batch(rng, 4, 10, REGIONS, n_words),
                 **_images(rng, 4)} for _ in range(2)]

    def grid():
        b = synthetic.make_retrieval_batch(rng, 2, 2, 10, REGIONS, n_words)
        return {**b, **_images(rng, 4)}
    if family == "retrieval_valid_tuples":
        return [(grid(), grid()) for _ in range(2)]
    return [grid() for _ in range(2)]


# family -> run_all_evals key
FAMILIES = {
    "mlm": "mlm_batches", "clm": "clm_batches", "mass": "mass_batches",
    "mt": "mt_batches", "ntg": "ntg_batches", "mmt": "mmt_batches",
    "caption": "caption_batches",
    "retrieval_valid_tuples": "retrieval_valid_batches",
    "retrieval_valid_plain": "retrieval_valid_batches",
    "slide": "slide_batches",
}


def _jax_masking(generator, tokens, valid_mask, cfg, mask_scores=None):
    """The JAX package's masking under the eval key's split
    (`m3p_tpu/train/steps.py:162`), for the port's ``mask_tokens``."""
    assert mask_scores is None
    r_mask, _ = jax.random.split(jax.random.PRNGKey(EVAL_SEED))
    out = jmasking.mask_tokens(
        r_mask, jnp.asarray(tokens.numpy()), jnp.asarray(valid_mask.numpy()),
        jmasking.MaskingConfig(**dataclasses.asdict(cfg)))
    return [torch.from_numpy(np.array(x)) for x in out]


def _assert_scores_close(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evaluator_family_matches_jax(small, family, monkeypatch):
    cfg = small["tcfg"].model
    data = {FAMILIES[family]: _family_data(family, cfg.n_words,
                                           cfg.mask_index)}
    want = small["jev"].run_all_evals(small["params"], data)
    if family == "mlm":
        monkeypatch.setattr(tsteps, "mask_tokens", _jax_masking)
    got = small["tev"].run_all_evals(data)
    _assert_scores_close(got, want)
    if family == "retrieval_valid_tuples":
        assert {"T2I_acc", "I2T_acc", "retrieval_acc"} <= set(got)


def test_two_run_all_evals_calls_are_equal(small):
    cfg = small["tcfg"].model
    data = {FAMILIES[f]: _family_data(f, cfg.n_words, cfg.mask_index)
            for f in ("mlm", "mass", "caption", "slide")}
    first = small["tev"].run_all_evals(data)
    assert small["tev"].run_all_evals(data) == first
    assert set(first) == {"mlm_ppl", "mlm_loss", "mass_ppl", "ic_ppl",
                          "ic_acc", "slide_acc"}


def _evaluators(small, tmp_path, **eval_kw):
    """A JAX and a port evaluator writing their artifacts to two
    directories, ``eval_kw`` set in both `EvalConfig`s."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"

    def cfg(key, path):
        c = small[key]
        return c.replace(eval=dataclasses.replace(
            c.eval, eval_path=str(path), **eval_kw))
    return (JaxEvaluator(small["jm"], cfg("jcfg", jdir)),
            Evaluator(small["model"], cfg("tcfg", tdir)), jdir, tdir)


def test_retrieval_test_and_its_artifacts_match_jax(small, tmp_path):
    jev, tev, jdir, tdir = _evaluators(small, tmp_path)
    cap_tokens, cap_len, feats, locs, img_len = _pool(4, n_img=5, n_cap=10)
    cap_to_img = np.arange(10) // 2
    grid = (cap_tokens, cap_len, cap_to_img, feats, locs, img_len, 4)
    want = jev.run_all_evals(small["params"], {"retrieval_test": grid})
    got = tev.run_all_evals({"retrieval_test": grid})
    _assert_scores_close(got, want)
    for d in (jdir, tdir):
        assert sorted(os.listdir(d)) == ["inference.log",
                                         "score_test_rank0.npy"]
    np.testing.assert_allclose(np.load(tdir / "score_test_rank0.npy"),
                               np.load(jdir / "score_test_rank0.npy"),
                               rtol=0, atol=GRID_ATOL)
    assert (tdir / "inference.log").read_text() == \
        (jdir / "inference.log").read_text()
    prefixed = tev.evaluate_retrieval_test(*grid, prefix="val_")
    assert set(prefixed) == {f"val_{k}" for k in got}
    assert os.path.exists(tdir / "score_val__rank0.npy")


def _gen_batches(kind, n_words, seed=11):
    rng = np.random.RandomState(seed)
    if kind == "caption":
        return [_images(rng, 3), _images(rng, 2)]
    out = []
    for b in (3, 2):
        mt = synthetic.make_mt_batch(rng, b, 9, n_words)
        batch = {"src_tokens": mt["src_tokens"], "src_len": mt["src_len"]}
        if kind == "mmt":
            batch.update(_images(rng, b))
        out.append(batch)
    return out


@pytest.mark.parametrize("kind,beam", [("caption", 1), ("caption", 3),
                                       ("mt", 3), ("mmt", 3), ("mt", 1)])
def test_generated_hypotheses_equal_jax(small, kind, beam):
    batches = _gen_batches(kind, small["tcfg"].model.n_words)
    if kind == "caption":
        want = small["jev"].generate_captions(small["params"], batches,
                                              small["jtok"], 1, beam)
        got = small["tev"].generate_captions(batches, small["ttok"], 1, beam)
    else:
        want = small["jev"].generate_translations(small["params"], batches,
                                                  small["jtok"], 1, beam)
        got = small["tev"].generate_translations(batches, small["ttok"], 1,
                                                 beam)
    assert got == want and len(got) == 5
    # the EOS bias makes hypotheses of different lengths
    assert len({len(h) for h in got}) > 1
    refs = [[h, "a dog runs"] for h in want[::-1]]
    assert tbleu(got, refs) == jbleu(want, refs)
    assert tcider(got, refs) == jcider(want, refs)


def _gen_data(small, kind, tok_key, **extra):
    refs = [["a dog runs on the beach", "two cats"], ["a man rides"],
            ["a red car"], ["the fox jumps", "a fox"], ["children play"]]
    data = {"batches": _gen_batches(kind, small["tcfg"].model.n_words),
            "references": refs, "tokenizer": small[tok_key], "lang_id": 1}
    data.update(extra)
    return data


def test_generation_evals_lang_prefixes_and_artifacts_match_jax(small,
                                                                tmp_path):
    jev, tev, jdir, tdir = _evaluators(small, tmp_path)
    ids = [f"img{i}" for i in range(5)]
    model = small["tcfg"].model

    def data(tok_key):
        return {
            "caption_gen.de": _gen_data(small, "caption", tok_key,
                                        image_ids=ids),
            "mt_gen": _gen_data(small, "mt", tok_key),
            "mmt_gen.en": _gen_data(small, "mmt", tok_key, name="mmt"),
            "slide_batches.en": _family_data("slide", model.n_words,
                                             model.mask_index)[:1],
        }
    want = jev.run_all_evals(small["params"], data("jtok"))
    got = tev.run_all_evals(data("ttok"))
    assert got == want
    assert {"de_caption_bleu", "de_caption_cider", "de_caption_meteor",
            "de_caption_rouge_l", "mt_bleu", "en_mmt_bleu",
            "en_slide_acc"} == set(got)
    name = "caption_translate.de.json"
    assert os.listdir(tdir) == [name] and os.listdir(jdir) == [name]
    port = json.loads((tdir / name).read_text())
    assert port == json.loads((jdir / name).read_text())
    assert [c["image_id"] for c in port] == ids


@pytest.mark.parametrize("coco_method,keys", [
    ("Bleu", {"caption_bleu"}),
    ("CIDEr, rouge_l", {"caption_cider", "caption_rouge_l"}),
    ("SPICE", {"caption_cider"}),
])
def test_coco_method_choice_and_fallback_match_jax(small, tmp_path,
                                                   coco_method, keys):
    jev, tev, _, _ = _evaluators(small, tmp_path, coco_method=coco_method)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    lg = logging.getLogger("m3p_tpu_torch")
    lg.addHandler(handler)
    try:
        got = tev.evaluate_captioning(
            **{k: v for k, v in _gen_data(small, "caption", "ttok").items()
               if k != "lang_id"}, tgt_lang_id=1)
    finally:
        lg.removeHandler(handler)
    want = jev.evaluate_captioning(
        small["params"], **{k: v for k, v in _gen_data(
            small, "caption", "jtok").items() if k != "lang_id"},
        tgt_lang_id=1)
    assert got == want and set(got) == keys
    warned = [r for r in records if r.levelno == logging.WARNING]
    assert bool(warned) == (coco_method == "SPICE")


def test_int8_eval_is_refused(small):
    """Only the exact and the frozen-weight int8 modes exist: another
    ``eval.quant`` is refused; "int8" builds the int8 copy of the model,
    sharing its parameters."""
    cfg = small["tcfg"]
    with pytest.raises(ValueError, match="int4"):
        Evaluator(small["model"], cfg.replace(
            eval=dataclasses.replace(cfg.eval, quant="int4")))
    ev = Evaluator(small["model"], cfg.replace(
        eval=dataclasses.replace(cfg.eval, quant="int8")))
    assert ev.gen_model is not ev.model
    assert ev.gen_model.cfg.ffn_quant == "int8_infer"
    assert all(a is b for a, b in zip(ev.gen_model.parameters(),
                                      small["model"].parameters()))
    assert small["tev"].gen_model is small["tev"].model


@pytest.mark.parametrize("kind,beam", [("caption", 3), ("caption", 1),
                                       ("mt", 3), ("mmt", 3)])
def test_int8_generation_evals_equal_jax(small, tmp_path, kind, beam):
    """``eval.quant="int8"``: the generation families encode and decode
    through the int8 model in both frameworks, the same strings."""
    jev, tev, _, _ = _evaluators(small, tmp_path, quant="int8")
    batches = _gen_batches(kind, small["tcfg"].model.n_words)
    if kind == "caption":
        want = jev.generate_captions(small["params"], batches,
                                     small["jtok"], 1, beam)
        got = tev.generate_captions(batches, small["ttok"], 1, beam)
    else:
        want = jev.generate_translations(small["params"], batches,
                                         small["jtok"], 1, beam)
        got = tev.generate_translations(batches, small["ttok"], 1, beam)
    assert got == want and len(got) == 5


def test_int8_eval_recaptures_after_an_optimizer_step(small, tmp_path):
    """The int8 tables follow the weights: a training step between two
    evals (in-place updates, so no parameter is a new object) makes the
    second eval capture again, and it decodes as a fresh evaluator over
    the updated weights does; an eval with no change in between keeps the
    tables."""
    cfg = small["tcfg"]
    model = build_model(cfg.model, 0, "cpu")
    model.load_state_dict(small["model"].state_dict())
    qcfg = cfg.replace(eval=dataclasses.replace(cfg.eval, quant="int8"))
    ev = Evaluator(model, qcfg)
    batches = _gen_batches("caption", cfg.model.n_words)
    ev.generate_captions(batches, small["ttok"], 1, 3)
    table = ev.gen_model.blocks[0].ffn.q8_lin1
    ev.generate_captions(batches, small["ttok"], 1, 3)
    assert ev.gen_model.blocks[0].ffn.q8_lin1 is table
    before = {k: v.clone() for k, v in q8_collection(ev.gen_model).items()}

    batch = ev._batch(_family_data("caption", cfg.model.n_words,
                                   cfg.model.mask_index)[0])
    loss, _ = tsteps.caption_loss(model, batch, ev._generators(),
                                  deterministic=True)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.sub_(0.5 * p.grad / (p.grad.abs().max() + 1e-12))
    got = ev.generate_captions(batches, small["ttok"], 1, 3)
    after = q8_collection(ev.gen_model)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    fresh = Evaluator(model, qcfg)
    assert got == fresh.generate_captions(batches, small["ttok"], 1, 3)
    for k, v in q8_collection(fresh.gen_model).items():
        assert torch.equal(v, after[k]), k


# ---------------------------------------------------------------------------
# the grid bench
# ---------------------------------------------------------------------------


def test_bench_eval_grid_on_the_cpu(capsys):
    rc = bench_eval_grid.main(["2", "5", "4", "--device", "cpu",
                               "--n_layers", "1", "--n_words", "300",
                               "--bucket"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pairs"] == 10 and out["chunk"] == 4 and out["bucket"]
    assert out["caplen"] == "8:20" and out["pairs_per_s"] > 0
    assert out["flops"] > 0 and out["card"] is None


@pytest.mark.parametrize("flag", ["--int8", "--q8"])
def test_bench_eval_grid_refuses_int8(flag, capsys):
    """``--int8`` (the dynamic int8 GEMMs, no longer refused) scores
    through ``ffn_quant="int8_bwd"``; beside ``--q8`` the int8 inference
    model wins, as in the JAX tool.  The scores equal the same model's
    grid scored directly."""
    from m3p_tpu_torch.ops import quant as quant_ops

    argv = ["2", "5", "4", "--device", "cpu", "--n_layers", "1",
            "--n_words", "300", "--int8"] + ([flag] if flag != "--int8"
                                              else [])
    quant_ops.zero_counts()
    assert bench_eval_grid.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pairs"] == 10 and out["pairs_per_s"] > 0
    if flag == "--q8":
        assert out["q8"] and out["ffn_quant"] == "int8_infer"
        assert quant_ops.int8_matmul_qbwd.calls == 0
    else:
        assert not out["q8"] and out["ffn_quant"] == "int8_bwd"
        # both FFN GEMMs of each joint forward: two passes of 3 chunks
        assert quant_ops.int8_matmul_qbwd.calls_by_pass == {"fwd": 12,
                                                            "bwd": 0}


def test_bench_eval_grid_q8_on_the_cpu(capsys):
    rc = bench_eval_grid.main(["2", "5", "4", "--device", "cpu",
                               "--n_layers", "1", "--n_words", "300",
                               "--q8"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["q8"] and out["q8_capture_secs"] > 0 and out["pairs"] == 10


def test_bench_eval_grid_pool_is_the_tools():
    cap_tokens, cap_len, feats, locs, img_len = bench_eval_grid.grid_pool(
        3, 7)
    rng = np.random.RandomState(0)
    want_len = rng.randint(8, 21, (7,))
    np.testing.assert_array_equal(cap_len, want_len)
    for i, n in enumerate(want_len):
        np.testing.assert_array_equal(cap_tokens[i, :n],
                                      rng.randint(4, 250000, n))
        assert (cap_tokens[i, n:] == 1).all()
    np.testing.assert_array_equal(feats, rng.randn(3, 100, 2048).astype(
        np.float32))
    assert cap_tokens.shape == (7, 64) and (img_len == 100).all()


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_and_cpu_models():
    cfg = tconfig.small_test_config()
    cpu = build_model(tconfig.ModelConfig(**dataclasses.asdict(cfg.model)),
                      0, "cpu")
    card = build_model(cpu.cfg, 0, "cpu").to("cuda")
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.gpu
def test_grid_scores_on_the_card_match_the_cpu(cuda_device):
    _, cpu, card = _card_and_cpu_models()
    pool = _pool(5)
    for bucket in (False, True):
        kw = dict(chunk_size=5, length_bucket=bucket, min_bucket=4)
        np.testing.assert_allclose(
            R.retrieval_grid_scores(card, *pool, **kw),
            R.retrieval_grid_scores(cpu, *pool, **kw), rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_loss_eval_on_the_card_matches_the_cpu(cuda_device):
    cfg, cpu, card = _card_and_cpu_models()
    data = {FAMILIES[f]: _family_data(f, 512, 511)
            for f in ("caption", "mt", "slide")}
    got = Evaluator(card, cfg).run_all_evals(data)
    _assert_scores_close(got, Evaluator(cpu, cfg).run_all_evals(data))
