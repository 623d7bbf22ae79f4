"""The port's serving stack against the JAX engine: tokenizer ids, ITM
scores and retrieval on the same vocab and weights (to 1e-4), captions
and translations (the same strings), padding invariance, the HTTP
contract of the port's server, and the CLI's flags."""

import dataclasses
import http.client
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.serve.engine import InferenceEngine as JaxEngine
from m3p_tpu.tokenization.tokenizer import XLMRTokenizer as JaxTokenizer
from m3p_tpu.tokenization.unigram import train_unigram
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.cli.serve import get_parser
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data.features import write_feature_shard
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.serve.engine import InferenceEngine, _bucket
from m3p_tpu_torch.serve.server import make_server
from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

torch.set_num_threads(1)

CORPUS = [
    "a dog runs on the beach",
    "two cats sleep on the sofa",
    "a man rides a bicycle",
    "the quick brown fox jumps",
    "a red car on the street",
] * 5

R = 4
D = 2048
TOL = 1e-4
TEXTS = ["a dog runs on the beach", "two cats sleep", "a man rides",
         "zebra quokka", " ".join(["very"] * 12)]
GEN_LEN = 8


def _image(rng, n=R):
    return {"feats": rng.randn(n, D).astype(np.float32),
            "locs": rng.rand(n, 5).astype(np.float32)}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_serve_tok") / "unigram.tsv")
    train_unigram(CORPUS, vocab_size=150).save(path)
    jtok = JaxTokenizer(path)
    jcfg = JaxModelConfig(
        n_words=jtok.vocab_size, mask_index=jtok.mask_token_id, n_langs=3,
        emb_dim=32, n_layers=2, n_dec_layers=2, n_heads=2, dropout=0.0,
        attention_dropout=0.0, max_region_num=R, refine_layers=1,
        dtype="float32", use_pallas_attention=False)
    jmodel, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    kw = dict(max_regions=R, text_buckets=(8, 16), batch_buckets=(1, 2, 4),
              beam_size=3, max_gen_len=GEN_LEN, lang2id={"en": 0, "de": 1})
    jeng = JaxEngine(jmodel, params, tokenizer=jtok, **kw)
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                          strict=True)
    teng = InferenceEngine(model, XLMRTokenizer(path), device="cpu", **kw)
    return jeng, teng


def test_bucket_helper():
    assert _bucket(1, (1, 2, 4)) == 1
    assert _bucket(3, (1, 2, 4)) == 4
    assert _bucket(9, (1, 2, 4)) == 4


def test_tokenizer_ids_match_jax(engines):
    jeng, teng = engines
    texts = TEXTS + ["Ünïcödé\tcontrol​space", ""]
    assert teng.tokenizer.vocab_size == jeng.tokenizer.vocab_size
    assert teng.tokenizer.mask_token_id == jeng.tokenizer.mask_token_id
    for t in texts:
        assert teng.tokenizer.encode(t) == jeng.tokenizer.encode(t), t
    assert (teng.tokenizer.encode_batch(texts, max_ids=6)
            == jeng.tokenizer.encode_batch(texts, max_ids=6))
    for bucketed in zip(teng._tokenize_bucketed(TEXTS),
                        jeng._tokenize_bucketed(TEXTS)[:2] + (
                            jeng._tokenize_bucketed(TEXTS)[3],)):
        np.testing.assert_array_equal(*bucketed)
    ids = teng.tokenizer.encode(TEXTS[0])
    assert teng.tokenizer.decode(ids) == jeng.tokenizer.decode(ids)


def test_score_matches_jax(engines):
    jeng, teng = engines
    rng = np.random.RandomState(0)
    images = [_image(rng, n) for n in (4, 3, 1, 2, 4, 2)]
    texts = TEXTS + ["a red car"]
    np.testing.assert_allclose(teng.score(texts, images),
                               jeng.score(texts, images), rtol=TOL, atol=TOL)


def test_score_padding_invariance(engines):
    _, teng = engines
    rng = np.random.RandomState(1)
    img = _image(rng)
    solo = teng.score([TEXTS[0]], [img])[0]
    batched = teng.score(TEXTS[:3], [img, _image(rng), _image(rng)])[0]
    assert abs(solo - batched) < TOL
    assert teng.score([TEXTS[4]], [img]) == teng.score([TEXTS[4]], [img])


def test_retrieve_matches_jax_and_pairwise_scores(engines):
    jeng, teng = engines
    rng = np.random.RandomState(2)
    gallery = [_image(rng, 1 + i % R) for i in range(6)]
    ids = [f"img{i}" for i in range(6)]
    assert teng.load_gallery(gallery, ids) == 6
    jeng.load_gallery(gallery, ids)
    text = "the quick brown fox jumps"
    got = teng.retrieve(text, top_k=6)
    want = {r["id"]: r["score"] for r in jeng.retrieve(text, top_k=6)}
    assert sorted(r["id"] for r in got) == sorted(want)
    for r in got:
        assert abs(r["score"] - want[r["id"]]) < TOL
    vals = [r["score"] for r in got]
    assert vals == sorted(vals, reverse=True)
    direct = teng.score([text] * 6, gallery)
    by_id = {r["id"]: r["score"] for r in got}
    for i, s in enumerate(direct):
        assert abs(by_id[f"img{i}"] - s) < TOL
    assert len(teng.retrieve(text, top_k=2)) == 2


def test_payload_errors(engines):
    _, teng = engines
    with pytest.raises(ValueError):
        teng.resolve_image({"image_id": "x"})
    with pytest.raises(ValueError):
        teng.resolve_image({"feats": np.zeros((2, 7), np.float32),
                            "locs": np.zeros((2, 5), np.float32)})
    boxes = np.array([[0, 0, 50, 50], [10, 10, 90, 80]], np.float32)
    feats, locs, n = teng.resolve_image(
        {"features": np.ones((2, D), np.float32), "boxes": boxes,
         "wh": [100.0, 100.0]})
    assert n == 2 and feats.shape == (R, D) and locs.shape == (R, 5)
    assert np.allclose(np.linalg.norm(feats[:2], axis=-1), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        teng.caption([{}])
    with pytest.raises(ValueError):
        teng.translate(["a dog"], tgt_lang="xx")
    # the position table has max_positions rows: the last step of a
    # max_len decode reads row max_len - 2
    limit = teng.model.cfg.max_positions + 1
    img = _image(np.random.RandomState(0), 1)
    for kw in ({"max_len": limit + 1}, {"max_len": 0}, {"beam_size": 0}):
        with pytest.raises(ValueError):
            teng.caption([img], **kw)
    with pytest.raises(ValueError):
        teng.translate(["a dog"], tgt_lang="de", max_len=limit + 1)


@pytest.mark.parametrize("beam", [1, 3])
def test_caption_matches_jax(engines, beam):
    """Greedy and beam captions of images with 1-4 regions, six images
    over the batch buckets (4 + 2 padded to 2): the JAX engine's
    strings."""
    jeng, teng = engines
    rng = np.random.RandomState(4)
    images = [_image(rng, n) for n in (4, 1, 3, 2, 4, 3)]
    got = teng.caption(images, beam_size=beam)
    assert got == jeng.caption(images, beam_size=beam)
    assert len(got) == 6 and all(isinstance(c, str) for c in got)
    assert teng.caption(images[:1], beam_size=beam) == got[:1]


@pytest.mark.parametrize("src_lang", [None, "en"])
def test_translate_matches_jax(engines, src_lang):
    jeng, teng = engines
    got = teng.translate(TEXTS, tgt_lang="de", src_lang=src_lang)
    assert got == jeng.translate(TEXTS, tgt_lang="de", src_lang=src_lang)
    assert len(got) == len(TEXTS)


def test_cli_parses_the_generation_flags():
    base = ["--reload_model", "m.pth", "--vocab_path", "v.tsv"]
    args = get_parser().parse_args(base)
    assert (args.beam_size, args.max_gen_len, args.length_penalty) == (
        5, 20, 1.0)
    args = get_parser().parse_args(base + [
        "--beam_size", "3", "--max_gen_len", "12", "--length_penalty",
        "0.6"])
    assert (args.beam_size, args.max_gen_len, args.length_penalty) == (
        3, 12, 0.6)


def _request(url, body=None, data=None):
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_endpoints(engines):
    _, teng = engines
    server, app = make_server(teng, host="127.0.0.1", port=0,
                              max_body_bytes=4_000_000)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        rng = np.random.RandomState(3)
        status, health = _request(base + "/health")
        assert status == 200 and health["status"] == "ok"
        assert health["devices"] == ["cpu"]

        def pair(text):
            im = _image(rng)
            return {"text": text, "feats": im["feats"].tolist(),
                    "locs": im["locs"].tolist()}

        one = pair(TEXTS[0])
        status, out = _request(base + "/v1/score", {"pairs": [one]})
        assert status == 200 and len(out["scores"]) == 1
        want = teng.score([TEXTS[0]], [one])[0]
        assert abs(out["scores"][0] - want) < TOL
        pairs = [one, pair(TEXTS[1]), pair(TEXTS[2])]
        status, out = _request(base + "/v1/score", {"pairs": pairs})
        assert status == 200 and len(out["scores"]) == 3
        assert abs(out["scores"][0] - want) < TOL

        teng.load_gallery([_image(rng) for _ in range(5)])
        status, out = _request(base + "/v1/retrieve",
                               {"text": TEXTS[1], "top_k": 3})
        assert status == 200 and len(out["results"]) == 3
        vals = [r["score"] for r in out["results"]]
        assert vals == sorted(vals, reverse=True)

        status, out = _request(base + "/v1/score", {"pairs": [{"text": "x"}]})
        assert status == 400, out
        status, out = _request(base + "/v1/score", data=b"[1, 2]")
        assert status == 400, out
        # an oversized body is refused on its declared length, unread
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=60)
        conn.putrequest("POST", "/v1/score")
        conn.putheader("Content-Length", str(5_000_000))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413 and b"exceeds" in resp.read()
        conn.close()
        im = _image(rng)
        img = {"feats": im["feats"].tolist(), "locs": im["locs"].tolist()}
        status, out = _request(base + "/v1/caption", {"images": [img]})
        assert status == 200 and len(out["captions"]) == 1, out
        status, custom = _request(base + "/v1/caption",
                                  {"images": [img], "beam_size": 3})
        assert status == 200 and custom == out
        assert out["captions"] == teng.caption([img])
        status, out = _request(base + "/v1/caption",
                               {"images": [img, img], "max_len": 5})
        assert status == 200 and len(out["captions"]) == 2
        status, out = _request(base + "/v1/translate",
                               {"texts": TEXTS[:2], "src_lang": "en",
                                "tgt_lang": "de"})
        assert status == 200, out
        assert out["translations"] == teng.translate(TEXTS[:2], "de", "en")
        for body in ({"texts": TEXTS[:1], "tgt_lang": "xx"},
                     {"texts": TEXTS[:1]},
                     {"texts": TEXTS[:1], "tgt_lang": "de",
                      "src_lang": "xx"}):
            status, out = _request(base + "/v1/translate", body)
            assert status == 400, out
        status, out = _request(base + "/v1/caption",
                               {"images": [{"locs": [[0.0] * 5]}]})
        assert status == 400, out
        for body in ({"images": [img], "max_len": 10000},
                     {"images": [img], "beam_size": 0}):
            status, out = _request(base + "/v1/caption", body)
            assert status == 400, out
        status, out = _request(base + "/v1/translate",
                               {"texts": TEXTS[:1], "tgt_lang": "de",
                                "max_len": 10000})
        assert status == 400, out
        status, _ = _request(base + "/nope", {})
        assert status == 404
    finally:
        server.shutdown()
        server.server_close()
        app.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# the store-backed gallery
# ---------------------------------------------------------------------------


def _shard(path, n, seed=5):
    rng = np.random.RandomState(seed)
    boxes = np.sort(rng.rand(n, R, 2, 2) * 20, axis=2).reshape(n, R, 4)
    write_feature_shard(
        path, features=rng.randn(n, R, D).astype(np.float32),
        boxes=boxes.astype(np.float32),
        num_boxes=rng.randint(1, R + 1, n).astype(np.int64),
        wh=np.tile(np.array([[20, 20]], np.float32), (n, 1)),
        image_ids=[f"im{i}" for i in range(n)])


def test_store_image_id_and_gallery_match_jax(engines, tmp_path):
    """``image_id`` payloads and `load_gallery_from_store` over an h5
    shard (`tests/test_serve.py:132`), against the JAX engine on the same
    shard."""
    jeng, teng = engines
    path = str(tmp_path / "feats.h5")
    _shard(path, 5)
    jeng.attach_store(path)
    teng.attach_store(path)
    try:
        for i in range(5):
            got, want = (e.resolve_image({"image_id": f"im{i}"})
                         for e in (teng, jeng))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        texts = [TEXTS[0], TEXTS[2]]
        images = [{"image_id": "im1"}, {"image_id": "im4"}]
        np.testing.assert_allclose(teng.score(texts, images),
                                   jeng.score(texts, images), rtol=TOL,
                                   atol=TOL)
        with pytest.raises(ValueError, match="unknown image_id"):
            teng.score(["a dog"], [{"image_id": "nope"}])
        assert teng.load_gallery_from_store(limit=3) == 3
        assert jeng.load_gallery_from_store(limit=3) == 3
        got = teng.retrieve(TEXTS[1], top_k=3)
        want = {r["id"]: r["score"] for r in jeng.retrieve(TEXTS[1],
                                                           top_k=3)}
        assert sorted(r["id"] for r in got) == sorted(want) == [
            "im0", "im1", "im2"]
        for r in got:
            assert abs(r["score"] - want[r["id"]]) < TOL
        assert teng.load_gallery_from_store() == 5
        assert teng.stats()["gallery_size"] == 5
    finally:
        for e in (jeng, teng):
            e.store, e._gallery = None, None
    with pytest.raises(ValueError, match="no feature store"):
        teng.load_gallery_from_store()


# ---------------------------------------------------------------------------
# frozen-weight int8 serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_engines(engines):
    """The port's int8 engine over the fixture's weights (fp32 compute, as
    in the JAX test), the plain port engine, and the JAX int8 engine."""
    from m3p_tpu.model import quantized_inference_model as jax_quantized

    from m3p_tpu_torch.model import quantized_inference_model

    jeng, teng = engines
    kw = dict(max_regions=R, text_buckets=(8,), batch_buckets=(1, 2, 4, 8),
              beam_size=1, max_gen_len=4, lang2id={"en": 0})
    fp = InferenceEngine(teng.model, teng.tokenizer, device="cpu", **kw)
    q8 = InferenceEngine(quantized_inference_model(teng.model),
                         teng.tokenizer, device="cpu", **kw)
    jq8 = JaxEngine(jax_quantized(jeng.model.cfg), jeng.params,
                    tokenizer=jeng.tokenizer, **kw)
    return fp, q8, jq8


def test_int8_vs_fp_score_ranking_invariance(int8_engines):
    """`tests/test_serve.py:458` on the port: int8 serving keeps the fp
    engine's top-1 and its ranking up to near-ties, scores within 15 % of
    the range; and the int8 scores equal the JAX int8 engine's within
    ``TOL``."""
    fp, q8, jq8 = int8_engines
    assert q8.q8_bytes > 0 and fp.q8_bytes == 0
    rng = np.random.RandomState(7)
    gallery = [_image(rng) for _ in range(8)]
    ids = [f"img{i}" for i in range(8)]
    for e in (fp, q8, jq8):
        e.load_gallery(gallery, ids)
    for text in ("a dog runs on the beach", "two cats sleep",
                 "a red car on the street"):
        r_fp, r_q8 = fp.retrieve(text, top_k=8), q8.retrieve(text, top_k=8)
        s_fp = {r["id"]: r["score"] for r in r_fp}
        s_q8 = {r["id"]: r["score"] for r in r_q8}
        s_jq8 = {r["id"]: r["score"] for r in jq8.retrieve(text, top_k=8)}
        span = max(s_fp.values()) - min(s_fp.values()) + 1e-6
        for k in s_fp:
            assert abs(s_fp[k] - s_q8[k]) < 0.15 * span, (k, s_fp, s_q8)
            assert abs(s_q8[k] - s_jq8[k]) < TOL, (k, s_q8, s_jq8)
        assert r_fp[0]["id"] == r_q8[0]["id"], (r_fp, r_q8)
        for a, b in zip([r["id"] for r in r_fp], [r["id"] for r in r_q8]):
            if a != b:
                assert abs(s_fp[a] - s_fp[b]) < 0.05 * span
    assert q8.caption(gallery[:2]) == jq8.caption(gallery[:2])


def test_cli_parses_the_store_and_quant_flags():
    base = ["--reload_model", "m.pth", "--vocab_path", "v.tsv"]
    args = get_parser().parse_args(base)
    assert (args.quant, args.features_path, args.load_gallery) == (
        "none", "", 0)
    args = get_parser().parse_args(base + [
        "--quant", "int8", "--features_path", "f.h5", "--load_gallery",
        "7"])
    assert (args.quant, args.features_path, args.load_gallery) == (
        "int8", "f.h5", 7)


def test_cli_main_builds_the_int8_engine_over_a_store(engines, tmp_path):
    """`main(argv, store=..., serve=False)`: the CLI's own parsing and
    engine construction over a store object, stopping before the server;
    ``--features_path`` over an h5 shard; an unknown ``--quant`` raises."""
    from m3p_tpu_torch.cli.serve import main
    from m3p_tpu_torch.data.features import RegionFeatureStore

    _, teng = engines
    ckpt = str(tmp_path / "model.pt")
    torch.save(teng.model.state_dict(), ckpt)
    vocab = teng.tokenizer._model_path
    cfg = teng.model.cfg
    argv = ["--reload_model", ckpt, "--vocab_path", vocab,
            "--emb_dim", str(cfg.emb_dim), "--n_layers", str(cfg.n_layers),
            "--n_heads", str(cfg.n_heads), "--max_region_num", str(R),
            "--refine_layers", str(cfg.refine_layers), "--lgs", "en-de",
            "--dtype", "float32", "--device", "cpu", "--warmup", "false",
            "--beam_size", "3", "--max_gen_len", str(GEN_LEN)]
    path = str(tmp_path / "feats.h5")
    _shard(path, 6, seed=9)
    store = RegionFeatureStore(path, R)
    engine = main(argv + ["--quant", "int8", "--load_gallery", "4"],
                  store=store, serve=False)
    assert engine.device.type == "cpu" and engine.store is store
    assert engine.model.cfg.ffn_quant == "int8_infer"
    assert engine.q8_bytes > 0 and engine.stats()["gallery_size"] == 4
    assert [r["id"] for r in engine.retrieve(TEXTS[0], top_k=4)] != []
    plain = main(argv + ["--features_path", path, "--load_gallery", "6"],
                 serve=False)
    assert plain.q8_bytes == 0 and plain.stats()["gallery_size"] == 6
    got = store.get(2)
    n = int(got["num_boxes"])
    np.testing.assert_allclose(
        plain.score([TEXTS[0]], [{"image_id": "im2"}]),
        teng.score([TEXTS[0]], [{"feats": got["feats"][:n],
                                 "locs": got["locs"][:n]}]),
        rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="unknown quant mode"):
        main(argv + ["--quant", "int4"], serve=False)
