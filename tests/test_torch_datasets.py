"""The port's datasets (m3p_tpu_torch.data.features, .clag, .datasets)
against the JAX package's over the same h5 shards: the feature store, the
Clager's draws, and every dataset family's ``epoch_iterator`` arrays for
the same (seed, epoch), equal bit for bit."""

import pickle

import numpy as np
import pytest

from m3p_tpu.data import clag as jax_clag
from m3p_tpu.data import datasets as JD
from m3p_tpu.data import features as jax_features
from m3p_tpu.data import loader as jax_loader
from m3p_tpu.tokenization.tokenizer import XLMRTokenizer as JaxTokenizer
from m3p_tpu.tokenization.unigram import train_unigram
from m3p_tpu_torch.data import clag, features
from m3p_tpu_torch.data import datasets as PD
from m3p_tpu_torch.data import loader as port_loader
from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

WORDS = ["red", "cat", "dog", "tree", "blue", "house", "runs", "small"]
# de words of the MCT lexicon: some of them are pieces of the vocab
LEXICON = [("red", "rot"), ("cat", "katze"), ("dog", "hund"),
           ("dog", "rüde"), ("tree", "baum"), ("blue", "blau")]
N_IMAGES, REGIONS, FEAT_DIM = 12, 4, 64


def write_shard(path, ids, rng, regions=REGIONS, dim=FEAT_DIM,
                classes="objects"):
    """A reference-layout shard of random features; ``classes`` is
    "objects", "distribution" or None."""
    n = len(ids)
    kw = {}
    if classes == "objects":
        kw["objects"] = rng.randint(0, 1600, (n, regions))
    elif classes == "distribution":
        kw["distribution"] = rng.rand(n, regions, 7).astype(np.float32)
    jax_features.write_feature_shard(
        str(path), features=rng.randn(n, regions, dim).astype(np.float32),
        boxes=np.abs(rng.rand(n, regions, 4)).astype(np.float32) * 50,
        num_boxes=rng.randint(1, regions + 1, n).astype(np.int64),
        wh=np.full((n, 2), 100, np.float32), image_ids=ids, **kw)


def sentences(rng, n, k=4):
    return [" ".join(rng.choice(WORDS, k)) for _ in range(n)]


def make_world(tmp):
    """A unigram vocab (the 80-piece one of `tests/test_checkpoint.py`),
    two shards of 12 images x 4 regions, 3 captions an image, an en-de
    lexicon; the JAX and the port objects over the same files."""
    rng = np.random.RandomState(0)
    vocab = str(tmp / "vocab.tsv")
    train_unigram(sentences(rng, 40, 5), vocab_size=80).save(vocab)
    ids = [[f"a{k}" for k in range(N_IMAGES)],
           [f"b{k}" for k in range(N_IMAGES)]]
    paths = [tmp / "shard0.h5", tmp / "shard1.h5"]
    for p, i in zip(paths, ids):
        write_shard(p, i, rng)
    captions = [{i: sentences(rng, 3) for i in group} for group in ids]
    lex = tmp / "en-de.txt"
    lex.write_text("".join(f"{a} {b}\n" for a, b in LEXICON) + "odd line x\n",
                   encoding="utf-8")
    return {
        "vocab": vocab, "paths": [str(p) for p in paths], "ids": ids,
        "captions": captions, "lexicon": str(lex),
        "jax": {"tok": JaxTokenizer(vocab),
                "stores": [jax_features.RegionFeatureStore(str(p), REGIONS)
                           for p in paths],
                "clager": jax_clag.Clager(jax_clag.load_bilingual_dict(
                    str(lex), "en", "de"), 0.8, 0.8)},
        "port": {"tok": XLMRTokenizer(vocab),
                 "stores": [features.RegionFeatureStore(str(p), REGIONS)
                            for p in paths],
                 "clager": clag.Clager(clag.load_bilingual_dict(
                     str(lex), "en", "de"), 0.8, 0.8)},
    }


def assert_same(got, want, where=""):
    """Equal trees of arrays: the same keys, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("datasets"))


@pytest.mark.parametrize("classes", ["objects", "distribution", None])
def test_feature_store_matches_jax(tmp_path, classes):
    rng = np.random.RandomState(1)
    path = tmp_path / "s.h5"
    write_shard(path, [f"x{k}" for k in range(5)], rng, regions=6,
                classes=classes)
    for r in (4, 8):   # cut and padded
        j = jax_features.RegionFeatureStore(str(path), r)
        p = features.RegionFeatureStore(str(path), r)
        assert len(p) == len(j) == 5 and p.feat_dim == j.feat_dim == FEAT_DIM
        assert list(p.image_ids) == list(j.image_ids)
        for img in ("x0", "x3"):
            assert p.index_of(img) == j.index_of(img)
        for i in range(5):
            for normalize in (True, False):
                assert_same(p.get(i, normalize), j.get(i, normalize))
            bufs = {}
            for side, store in (("p", p), ("j", j)):
                raw = np.full((r, FEAT_DIM), 7.0, np.float32)
                locs = np.full((r, 5), 7.0, np.float32)
                objs = np.full((r,), 7, np.int32)
                n = store.get_into(i, raw, locs, objs)
                bufs[side] = (n, raw, locs, objs)
            assert bufs["p"][0] == bufs["j"][0]
            assert_same(bufs["p"][1:], bufs["j"][1:])
    # a store crosses a process boundary as its path alone
    state = p.__getstate__()
    assert state == {"path": str(path), "max_region_num": 8}
    copy = pickle.loads(pickle.dumps(p))
    assert_same(copy.get(2), p.get(2))


def test_write_feature_shard_is_read_by_the_jax_store(tmp_path):
    rng = np.random.RandomState(2)
    path = str(tmp_path / "w.h5")
    feats = rng.randn(3, 4, 16).astype(np.float32)
    features.write_feature_shard(
        path, features=feats, boxes=np.ones((3, 4, 4), np.float32),
        num_boxes=np.array([4, 2, 1]), wh=np.full((3, 2), 8, np.float32),
        image_ids=["p", "q", "r"], objects=np.zeros((3, 4), np.int64))
    j = jax_features.RegionFeatureStore(path, 4)
    assert list(j.image_ids) == ["p", "q", "r"]
    np.testing.assert_array_equal(j.get(1, normalize=False)["raw_feats"],
                                  feats[1])
    assert int(j.get(1)["num_boxes"]) == 2


def test_clager_draws_match_jax(world):
    pc, jc = world["port"]["clager"], world["jax"]["clager"]
    assert pc.lexicon == jc.lexicon
    assert clag.load_bilingual_dict(world["lexicon"], "de", "en") == \
        jax_clag.load_bilingual_dict(world["lexicon"], "de", "en")
    texts = sentences(np.random.RandomState(3), 30, 6)
    a, b = np.random.RandomState(9), np.random.RandomState(9)
    for text in texts:
        assert pc.clag(a, text, "en") == jc.clag(b, text, "en")
        assert pc.dclag(a, text, "en", 1, 3) == jc.dclag(b, text, "en", 1, 3)
        word = text.split()[0]
        for pos in (True, False):
            assert pc.clag_word(a, word, "en", pos) == \
                jc.clag_word(b, word, "en", pos)
        assert pc.clag(a, text, "fr") == text    # no lexicon for fr
    # the generators are still in step
    assert a.randint(1 << 30) == b.randint(1 << 30)
    none = clag.Clager(None, 1.0, 1.0)
    assert none.dclag(a, "red cat", "en", 1, 2) == ["red cat"] * 3


def _pair(world, make, **kw):
    """The port's and the JAX dataset built by ``make(module, side,
    captions, **kw)``."""
    caps = world["captions"]
    return (make(PD, world["port"], caps, **kw),
            make(JD, world["jax"], caps, **kw))


def _retrieval(m, side, caps, clager=False):
    return m.RetrievalDataset(
        caps[0], side["stores"][0], side["tok"], sample_n=3, max_len=12,
        clager=side["clager"] if clager else None, seed=4)


def _take(iterator, n=None):
    out = list(iterator)
    return out if n is None else out[:n]


@pytest.mark.parametrize("clager", [False, True])
@pytest.mark.parametrize("epoch", [0, 3])
def test_retrieval_grids_match_jax(world, clager, epoch):
    p, j = _pair(world, _retrieval, clager=clager)
    assert len(p) == len(j) == N_IMAGES
    for bs in (2, 5):
        assert_same(_take(p.epoch_iterator(bs, epoch)),
                    _take(j.epoch_iterator(bs, epoch)))


def _pretrain(m, side, caps, train_order=None):
    return m.PretrainDataset(
        side["stores"], caps, side["tok"], train_order=train_order,
        sample_n=3, max_len=10, clager=side["clager"], seed=2)


@pytest.mark.parametrize("train_order", [None, [[1], [0], [1]]])
def test_pretrain_shards_dclag_and_clcm_match_jax(world, train_order):
    p, j = _pair(world, _pretrain, train_order=train_order)
    for epoch in (0, 1, 2):
        for clcm in (False, True):
            assert_same(_take(p.epoch_iterator(4, epoch, with_clcm=clcm)),
                        _take(j.epoch_iterator(4, epoch, with_clcm=clcm)))
        assert p.store.path == j.store.path and p.image_ids == j.image_ids


@pytest.mark.parametrize("qp_type", ["q", "qp"])
def test_mild_grids_match_jax(world, qp_type):
    rng = np.random.RandomState(5)
    queries = {i: [(s, t) for s, t in zip(sentences(rng, 2, 3),
                                          sentences(rng, 2, 5))]
               for i in world["ids"][1]}

    def make(m, side, caps):
        return m.MILDDataset(queries, side["stores"][1], side["tok"],
                             qp_type=qp_type, sample_n=2, max_len=16, seed=1)

    p, j = _pair(world, make)
    assert p.captions == j.captions
    assert_same(_take(p.epoch_iterator(3, 1)), _take(j.epoch_iterator(3, 1)))


@pytest.mark.parametrize("variant", ["plain", "clag_noise_lang", "eval"])
def test_caption_batches_match_jax(world, variant):
    def make(m, side, caps):
        kw = {}
        if variant == "clag_noise_lang":
            kw = dict(clager=side["clager"], region_noise=True, lang_id=3)
        return m.CaptionDataset(caps[0], side["stores"][0],
                                side["tok"], max_len=12, seed=6, **kw)

    p, j = _pair(world, make)
    assert p.items == j.items
    if variant == "eval":
        # the generation eval's layout: unshuffled, a short last batch
        assert_same(_take(p.epoch_iterator(5, 0, shuffle=False,
                                           drop_last=False)),
                    _take(j.epoch_iterator(5, 0, shuffle=False,
                                           drop_last=False)))
    else:
        assert_same(_take(p.epoch_iterator(4, 2)),
                    _take(j.epoch_iterator(4, 2)))


def test_pretrain_caption_shard_schedule_matches_jax(world):
    def make(m, side, caps):
        return m.PretrainCaptionDataset(
            side["stores"], caps, side["tok"],
            train_order=[[1], [0]], max_len=10, clager=side["clager"],
            seed=3, region_noise=True)

    p, j = _pair(world, make)
    for epoch in (0, 1):
        assert_same(_take(p.epoch_iterator(6, epoch)),
                    _take(j.epoch_iterator(6, epoch)))
        assert p.store.path == j.store.path


@pytest.mark.parametrize("transform", [None, "mass", "bart", "bart_noise",
                                       "ae"])
def test_streams_match_jax(transform):
    stream = np.random.RandomState(7).randint(4, 70, 1000).astype(np.int32)

    def make(m, loader):
        if transform is None:
            return m.StreamDataset(stream, bptt=16, seed=5, n_feeders=2,
                                   feeder_id=1)
        fn = {"mass": lambda: loader.make_mass_transform(0.5, 79, 80),
              "bart": lambda: loader.make_bart_transform(79),
              "bart_noise": lambda: loader.make_bart_transform(
                  79, noise=(3.0, 0.1, 0.1)),
              "ae": lambda: loader.make_ae_transform(3.0, 0.1, 0.1, 79)
              }[transform]()
        return m.NoisedStreamDataset(stream, fn, lang_id=1, bptt=16, seed=5)

    p, j = make(PD, port_loader), make(JD, jax_loader)
    assert len(p) == len(j)
    for epoch in (0, 1):
        assert_same(_take(p.epoch_iterator(4, epoch)),
                    _take(j.epoch_iterator(4, epoch)))
    # the resumable cursor
    p.position = j.position = 0
    next(p.epoch_iterator(4, 2)), next(j.epoch_iterator(4, 2))
    assert p.state_dict() == j.state_dict() == {"position": 4}
    p.load_state_dict({"position": 8})
    j.load_state_dict({"position": 8})
    assert_same(_take(p.epoch_iterator(4, 2)), _take(j.epoch_iterator(4, 2)))


def test_pc_batches_match_jax(world):
    rng = np.random.RandomState(8)
    src, tgt = sentences(rng, 11, 5), sentences(rng, 11, 3)

    def make(m, side, caps):
        return m.PCDataset(src, tgt, side["tok"], max_len=10, seed=2,
                           src_lang_id=0, tgt_lang_id=1)

    p, j = _pair(world, make)
    assert_same(_take(p.epoch_iterator(3, 1)), _take(j.epoch_iterator(3, 1)))


@pytest.mark.parametrize("variant", ["grouped", "shuffled", "unshuffled",
                                     "multimodal"])
def test_parallel_batches_match_jax(world, variant):
    rng = np.random.RandomState(9)
    src = [" ".join(rng.choice(WORDS, rng.randint(1, 7))) for _ in range(12)]
    tgt = sentences(rng, 12, 4)
    ids = world["ids"][0]

    def make(m, side, caps):
        kw = dict(group_by_size=variant == "grouped")
        if variant == "multimodal":
            kw.update(store=side["stores"][0], image_ids=ids)
        return m.ParallelDataset(src, tgt, side["tok"], max_len=9, seed=3,
                                 src_lang_id=0, tgt_lang_id=1, **kw)

    p, j = _pair(world, make)
    shuffle = variant != "unshuffled"
    assert_same(_take(p.epoch_iterator(4, 2, shuffle=shuffle)),
                _take(j.epoch_iterator(4, 2, shuffle=shuffle)))


def test_slide_batches_match_jax(world):
    rng = np.random.RandomState(10)
    items = [(i, s, int(rng.rand() < 0.5)) for i, s in
             zip(world["ids"][1], sentences(rng, N_IMAGES))]

    def make(m, side, caps):
        return m.SlideDataset(items, side["stores"][1], side["tok"],
                              max_len=8, seed=4)

    p, j = _pair(world, make)
    assert_same(_take(p.epoch_iterator(5, 1)), _take(j.epoch_iterator(5, 1)))


@pytest.mark.parametrize("caps_per_image", [1, 2, 5])
def test_eval_retrieval_arrays_match_jax(world, caps_per_image):
    got = PD.build_eval_retrieval_arrays(
        world["captions"][1], world["port"]["stores"][1], world["port"]["tok"],
        max_len=12, caps_per_image=caps_per_image)
    want = JD.build_eval_retrieval_arrays(
        world["captions"][1], world["jax"]["stores"][1], world["jax"]["tok"],
        max_len=12, caps_per_image=caps_per_image)
    assert_same(tuple(got), tuple(want))
