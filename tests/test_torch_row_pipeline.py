"""The port's row loader (m3p_tpu_torch.data.row_pipeline) against the JAX
package's grain loader: grain's shuffle permutation, each family's record
bit for bit for the same key, whole epochs of batches in grain's order, the
read threads changing nothing, and a saved position resuming mid-pass."""

import json
import logging

import numpy as np
import pytest

from grain._src.python.experimental.index_shuffle.python import (
    index_shuffle_module as grain_shuffle)
from m3p_tpu.data import datasets as JD
from m3p_tpu.data import grain_pipeline as JG
from m3p_tpu.data import loader as jax_loader
from m3p_tpu_torch.data import datasets as PD
from m3p_tpu_torch.data import loader as port_loader
from m3p_tpu_torch.data import row_pipeline as RP
from test_torch_datasets import (N_IMAGES, assert_same, make_world,
                                 sentences)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("rows"))


@pytest.mark.parametrize("n", [1, 2, 3, 10, 17, 100, 1000, 65535, 65536,
                               65537, 300001])
def test_index_shuffle_is_grains(n):
    """Grain's C++ permutation, which `MapDataset.shuffle` applies per
    pass: every block width from the 16-bit floor up, cycle-walking at
    small n, the power-of-two edges."""
    rng = np.random.RandomState(n)
    idx = np.arange(n) if n <= 2000 else rng.randint(0, n, 1500)
    for seed in (0, 5, 12345, 2 ** 32 - 1, 31 * 7 + 2):
        got = RP.index_shuffle(idx, n - 1, seed)
        want = [grain_shuffle.index_shuffle(int(i), max_index=n - 1,
                                            seed=seed, rounds=4)
                for i in idx]
        np.testing.assert_array_equal(got, want)
    if n <= 2000:    # a permutation of [0, n)
        assert sorted(RP.index_shuffle(np.arange(n), n - 1, 9)) == \
            list(range(n))


def test_index_shuffle_takes_grains_round_counts():
    idx = np.arange(300)
    for rounds in (4, 6, 8):
        want = [grain_shuffle.index_shuffle(int(i), max_index=299, seed=7,
                                            rounds=rounds) for i in idx]
        np.testing.assert_array_equal(RP.index_shuffle(idx, 299, 7, rounds),
                                      want)
    for rounds in (2, 5):
        with pytest.raises(ValueError, match="rounds"):
            RP.index_shuffle(idx, 299, 7, rounds)


def _families(world):
    """(name, port dataset, JAX dataset, make-kwargs) of every family the
    row loader takes."""
    p, j = world["port"], world["jax"]
    caps = world["captions"]
    rng = np.random.RandomState(11)
    src, tgt = sentences(rng, 14, 5), sentences(rng, 14, 3)
    slide = [(i, s, int(rng.rand() < 0.5)) for i, s in
             zip(world["ids"][1], sentences(rng, N_IMAGES))]
    stream = rng.randint(4, 70, 700).astype(np.int32)
    out = []
    for m, side, loader in ((PD, p, port_loader), (JD, j, jax_loader)):
        out.append({
            "retrieval": m.RetrievalDataset(
                caps[0], side["stores"][0], side["tok"], sample_n=3,
                max_len=12, clager=side["clager"], seed=1),
            "pretrain": m.PretrainDataset(
                side["stores"], caps, side["tok"], train_order=[[1], [0]],
                sample_n=2, max_len=10, clager=side["clager"], seed=2),
            "caption": m.CaptionDataset(
                caps[0], side["stores"][0], side["tok"], max_len=12,
                clager=side["clager"], region_noise=True, lang_id=2),
            "pretrain_caption": m.PretrainCaptionDataset(
                side["stores"], caps, side["tok"], train_order=[[1], [0]],
                max_len=12),
            "slide": m.SlideDataset(slide, side["stores"][1], side["tok"],
                                    max_len=8),
            "parallel": m.ParallelDataset(
                src, tgt, side["tok"], max_len=9, src_lang_id=0,
                tgt_lang_id=1),
            "parallel_mm": m.ParallelDataset(
                src[:N_IMAGES], tgt[:N_IMAGES], side["tok"], max_len=9,
                store=side["stores"][0], image_ids=world["ids"][0]),
            "pc": m.PCDataset(src, tgt, side["tok"], max_len=8,
                              src_lang_id=0, tgt_lang_id=1),
            "stream": m.StreamDataset(stream, bptt=16),
            "mass": m.NoisedStreamDataset(
                stream, loader.make_mass_transform(0.5, 79, 80), lang_id=1,
                bptt=16),
            "bart": m.NoisedStreamDataset(
                stream, loader.make_bart_transform(79, noise=(3.0, 0.1, 0.1)),
                lang_id=1, bptt=16),
        })
    return out


FAMILIES = ["retrieval", "pretrain", "caption", "pretrain_caption", "slide",
            "parallel", "parallel_mm", "pc", "stream", "mass", "bart"]
SOURCES = {"retrieval": "_grid_pair_source", "pretrain": "_grid_pair_source",
           "caption": "_caption_source", "pretrain_caption": "_caption_source",
           "slide": "_slide_source", "parallel": "_parallel_source",
           "parallel_mm": "_parallel_source", "pc": "_pc_source",
           "stream": "_stream_source", "mass": "_stream_source",
           "bart": "_stream_source"}


@pytest.fixture(scope="module")
def families(world):
    return _families(world)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_record_is_the_jax_record_for_its_key(families, family):
    port, jax_ = families[0][family], families[1][family]
    assert RP.supports_grain(port) and JG.supports_grain(jax_)
    kw = {"with_clcm": True} if SOURCES[family] == "_grid_pair_source" \
        else {}
    if family == "pretrain":
        port.update(1), jax_.update(1)
    ps = getattr(RP, SOURCES[family])(port, 37, **kw)
    js = getattr(JG, SOURCES[family])(jax_, 37, **kw)
    assert len(ps) == len(js) and repr(ps) == repr(js)
    for key in list(range(len(js))) + [len(js) + 3]:
        assert_same(ps[key], js[key], f"{family}[{key}]")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("num_epochs", [1, 2])
def test_batches_are_the_grain_loaders(families, family, num_epochs):
    """Whole runs of batches, passes laid end to end (a batch may span
    two), in grain's order, with 3 read threads."""
    port, jax_ = families[0][family], families[1][family]
    bs = 5
    got = list(RP.make_row_loader(port, bs, seed=3, epoch=1, with_clcm=True,
                                  num_epochs=num_epochs, worker_count=3))
    want = list(JG.make_grain_loader(jax_, bs, seed=3, epoch=1,
                                     with_clcm=True, num_epochs=num_epochs))
    assert len(got) == len(want) > 0
    assert_same(got, want, family)


def test_read_threads_change_no_batch(families):
    for family in ("retrieval", "caption", "mass"):
        ds = families[0][family]
        one, three = (list(RP.make_row_loader(ds, 4, seed=2, num_epochs=2,
                                              worker_count=w))
                      for w in (1, 3))
        assert_same(three, one, family)


@pytest.mark.parametrize("family", ["retrieval", "caption", "stream"])
def test_saved_position_resumes_bitwise(families, family):
    ds = families[0][family]
    loader = RP.make_row_loader(ds, 3, seed=4, epoch=2, num_epochs=2,
                                worker_count=2)
    whole = list(loader)
    it = iter(loader)
    for _ in range(2):
        next(it)
    state = RP.save_loader_state(it)
    assert json.loads(state)["next_batch"] == 2
    # a consumer two batches behind the iterator saves its own position
    assert json.loads(RP.save_loader_state(it, consumed=1))["next_batch"] == 1
    it.close()
    fresh = iter(RP.make_row_loader(ds, 3, seed=4, epoch=2, num_epochs=2,
                                    worker_count=3))
    RP.restore_loader_state(fresh, state)
    assert fresh.start == 2
    assert_same(list(fresh), whole[2:], family)
    # seeking an iterator that has run ahead
    again = iter(loader)
    for _ in range(4):
        next(again)
    RP.restore_loader_state(again, json.loads(state))
    assert_same(next(again), whole[2], family)
    again.close()


def test_unreadable_states_raise_value_error(families):
    ds = families[0]["caption"]
    it = iter(RP.make_row_loader(ds, 3, seed=4))
    good = json.loads(RP.save_loader_state(it))
    bad = [
        "not json", json.dumps([1]), {"next_index": 1},   # grain's own
        {**good, "format": "other/1"},
        {**good, "batch_size": 4}, {**good, "shuffle_seed": 5},
        {**good, "num_epochs": 2}, {**good, "next_batch": -1},
        {**good, "next_batch": 10 ** 6}, {**good, "next_batch": "2"},
    ]
    other = iter(RP.make_row_loader(families[0]["slide"], 3, seed=4))
    bad.append(json.loads(RP.save_loader_state(other)))   # another source
    for state in bad:
        with pytest.raises(ValueError):
            RP.restore_loader_state(it, state)
    RP.restore_loader_state(it, good)


def test_loader_refuses_what_it_has_no_source_for():
    with pytest.raises(TypeError, match="no row source"):
        RP.make_row_loader(object(), 2)
    assert not RP.supports_grain(object())


def test_many_read_threads_warn_without_a_number(families):
    ds = families[0]["caption"]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("m3p_tpu_torch")
    logger.addHandler(handler)
    try:
        RP.make_row_loader(ds, 2, worker_count=4)
        warned = [r for r in records if r.levelno >= logging.WARNING]
        assert not warned
        RP.make_row_loader(ds, 2, worker_count=8)
    finally:
        logger.removeHandler(handler)
    msgs = [r.getMessage() for r in records if r.levelno >= logging.WARNING]
    assert len(msgs) == 1 and "worker_count=8" in msgs[0]
    # the JAX loader's warning quotes rows/s measured on another host
    assert "rows/s" not in msgs[0] and not any(
        ch.isdigit() for ch in msgs[0].replace("worker_count=8", "")
        .replace("past 4", ""))
