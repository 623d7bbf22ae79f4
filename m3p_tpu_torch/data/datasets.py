"""Datasets: candidate-grid samplers and batch iterators for every task
family (a copy of `m3p_tpu/data/datasets.py`).

The retrieval grids (`RetrievalDataset`, with compact per-group image
pools), pre-training over sharded corpora with its per-epoch shard schedule,
MCT and CLCM (`PretrainDataset`, `PretrainCaptionDataset`), MILD, captions,
text streams (plain and noised), parallel classification, parallel text
and slides, and `build_eval_retrieval_arrays` for the eval grid.  Each is a
plain-Python iterator over numpy batches with an explicit seeded
``RandomState``, drawing in the JAX package's order: the same (seed, epoch)
gives the same arrays.  `data/pipeline.py` stages the batches on the
device; `data/row_pipeline.py` builds the checkpointable row loader over
the same datasets.

All iterators emit fixed-shape batches in the layouts of `train/steps.py`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from m3p_tpu_torch.config import PAD_IDX
from m3p_tpu_torch.data.clag import Clager
from m3p_tpu_torch.data.features import RegionFeatureStore
from m3p_tpu_torch.tokenization.tokenizer import batch_sentences

Batch = Dict[str, np.ndarray]


def _encode_padded(tokenizer, texts: Sequence[str], max_len: int,
                   lang_ids: Optional[Sequence[int]] = None):
    ids = tokenizer.encode_batch(texts, max_ids=max_len - 2)
    return batch_sentences(ids, max_len=max_len, lang_ids=lang_ids)


def _grid_img_index(b: int, n: int, direction: str) -> np.ndarray:
    """Local per-group gather map for compact grids: t2i rows index their
    own candidate slot (identity), i2t rows all share pool slot 0."""
    if direction == "t2i":
        return np.tile(np.arange(n, dtype=np.int32), (b, 1))
    return np.zeros((b, n), np.int32)


class RetrievalDataset:
    """Fine-tune image-text retrieval with t2i/i2t candidate grids.

    Reference semantics (`dataset_finetune.py:299-703`): per epoch each image
    contributes one of its captions (resampled per epoch, `update_captions`);
    a t2i item is (1 caption, sample_n images with 1 positive), an i2t item is
    (1 image, sample_n captions with 1 positive); positions of positives are
    uniform; optional MCT via `clager.clag`.
    """

    def __init__(
        self,
        captions: Dict[str, List[str]],      # image_id -> caption list
        store: RegionFeatureStore,
        tokenizer,
        lang: str = "en",
        sample_n: int = 4,
        max_len: int = 64,
        clager: Optional[Clager] = None,
        seed: int = 0,
    ):
        self.captions = captions
        self.store = store
        self.tokenizer = tokenizer
        self.lang = lang
        self.sample_n = sample_n
        self.max_len = max_len
        self.clager = clager
        self.seed = seed
        self.image_ids = [i for i in captions.keys()]

    def __len__(self) -> int:
        return len(self.image_ids)

    def _image_pools(self, store_indices: List[List[int]]) -> Batch:
        """Fill per-group image pools: ``store_indices[g]`` lists the h5 rows
        of group g's pool.  Returns the compact grouped image arrays
        (`raw_feats` (G, U, R, D), `locs` (G, U, R, 5), `obj_labels`
        (G, U, R), `img_len` (G, U)) that `expand_compact_batch` gathers and
        L2-normalizes on device — host ships each unique image once instead
        of `np.stack`-ing duplicated normalized+raw copies per grid row,
        which is less work on the host and fewer bytes to the device."""
        g = len(store_indices)
        u = max(len(p) for p in store_indices)
        r = self.store.max_region_num
        d = self.store.feat_dim
        raw = np.zeros((g, u, r, d), np.float32)
        locs = np.zeros((g, u, r, 5), np.float32)
        objs = np.full((g, u, r), -1, np.int32)
        lens = np.zeros((g, u), np.int32)
        for gi, pool in enumerate(store_indices):
            for ui, store_idx in enumerate(pool):
                lens[gi, ui] = self.store.get_into(
                    store_idx, raw[gi, ui], locs[gi, ui], objs[gi, ui])
        return {"raw_feats": raw, "locs": locs, "obj_labels": objs,
                "img_len": lens}

    def _grid_batch(self, rng, anchor_ids: List[str], direction: str) -> Batch:
        """Build a compact grid batch for ``direction`` in {t2i, i2t}:
        tokens are grid-flattened (B = b * sample_n rows), image data is
        per-group pools + a local ``img_index`` gather map (t2i: U = n
        candidate images, identity map; i2t: U = 1 shared anchor image).

        The two directions therefore have different pool shapes.  This is
        deliberate: padding i2t pools to U = n would give one shape but
        re-ship (n-1)/n zero bytes per i2t batch, on every step."""
        n = self.sample_n
        b = len(anchor_ids)
        texts: List[str] = []
        pools: List[List[int]] = []
        pos_label = rng.randint(0, n, size=b).astype(np.int32)
        for gi, img_id in enumerate(anchor_ids):
            caps = self.captions[img_id]
            cap = caps[rng.randint(len(caps))]
            if self.clager is not None:
                cap = self.clager.clag(rng, cap, self.lang)
            negatives = [self.image_ids[rng.randint(len(self.image_ids))]
                         for _ in range(n)]
            if direction == "t2i":
                # same caption (tokenized once, rows repeated below),
                # candidate images
                texts.append(cap)
                pool = []
                for slot in range(n):
                    cand = img_id if slot == pos_label[gi] else negatives[slot]
                    pool.append(self.store.index_of(cand))
                pools.append(pool)
            else:
                # same image, candidate captions
                for slot in range(n):
                    if slot == pos_label[gi]:
                        texts.append(cap)
                    else:
                        neg_caps = self.captions[negatives[slot]]
                        neg = neg_caps[rng.randint(len(neg_caps))]
                        if self.clager is not None:
                            neg = self.clager.clag(rng, neg, self.lang)
                        texts.append(neg)
                pools.append([self.store.index_of(img_id)])
        tokens, lengths, _ = _encode_padded(self.tokenizer, texts,
                                            self.max_len)
        if direction == "t2i":
            # one tokenized caption per group -> n identical grid rows
            tokens = np.repeat(tokens, n, axis=0)
            lengths = np.repeat(lengths, n, axis=0)
        batch = {
            "tokens": tokens,
            "text_len": lengths,
            "pos_label": pos_label,
            "img_index": _grid_img_index(b, n, direction),
        }
        batch.update(self._image_pools(pools))
        return batch

    def epoch_iterator(self, batch_size: int, epoch: int = 0
                       ) -> Iterator[Tuple[Batch, Batch]]:
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(len(self.image_ids))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            ids = [self.image_ids[i] for i in order[start:start + batch_size]]
            yield (self._grid_batch(rng, ids, "t2i"),
                   self._grid_batch(rng, ids, "i2t"))


def _shard_for_epoch(train_order, epoch: int, feeder_id: int,
                     n_feeders: int, n_shards: int) -> int:
    """Per-epoch, per-feeder shard choice (`dataset_pretrain.py:210-226`):
    the `train_order` JSON row wins; round-robin otherwise."""
    if train_order is not None:
        row = train_order[epoch % len(train_order)]
        return row[feeder_id % len(row)]
    return (epoch * n_feeders + feeder_id) % n_shards


class PretrainDataset(RetrievalDataset):
    """Pre-training over sharded CC/SBU-style corpora with MCT and CLCM.

    Adds the reference shard schedule (`dataset_pretrain.py:210-226`): a
    ``train_order`` table maps epoch -> shard per data-parallel feeder;
    ``update(epoch, feeder)`` switches the active shard.  Items use
    `clager.dclag` (positives/negatives by code-switch substitution) and i2t
    batches add CLCM concat-caption pairs (`sample_captions`,
    `dataset_pretrain.py:412-497`).
    """

    def __init__(self, shards: Sequence[RegionFeatureStore],
                 captions_per_shard: Sequence[Dict[str, List[str]]],
                 tokenizer, train_order: Optional[Sequence[Sequence[int]]] = None,
                 n_feeders: int = 1, feeder_id: int = 0, **kw):
        self.shards = list(shards)
        self.captions_per_shard = list(captions_per_shard)
        self.train_order = train_order
        self.n_feeders = n_feeders
        self.feeder_id = feeder_id
        super().__init__(captions_per_shard[0], shards[0], tokenizer, **kw)
        self.update(0)

    def update(self, epoch: int) -> None:
        shard_idx = _shard_for_epoch(self.train_order, epoch, self.feeder_id,
                                     self.n_feeders, len(self.shards))
        self.store = self.shards[shard_idx]
        self.captions = self.captions_per_shard[shard_idx]
        self.image_ids = list(self.captions.keys())

    def _grid_batch(self, rng, anchor_ids: List[str], direction: str) -> Batch:
        """Pretrain i2t grids use `dclag` code-switch variants of ONE caption
        as the candidates — the positive slot gets a true code-switched
        translation, negative slots get corrupted substitutions
        (`dataset_pretrain.py:363, sample_captions`).  t2i keeps the
        different-image candidate semantics of the parent."""
        if direction == "t2i" or self.clager is None:
            return super()._grid_batch(rng, anchor_ids, direction)
        n = self.sample_n
        b = len(anchor_ids)
        pos_label = rng.randint(0, n, size=b).astype(np.int32)
        texts: List[str] = []
        for gi, img_id in enumerate(anchor_ids):
            caps = self.captions[img_id]
            cap = caps[rng.randint(len(caps))]
            variants = self.clager.dclag(rng, cap, self.lang, 1, n - 1)
            pos_variant, neg_variants = variants[0], variants[1:]
            vi = 0
            for slot in range(n):
                if slot == pos_label[gi]:
                    texts.append(pos_variant)
                else:
                    texts.append(neg_variants[vi])
                    vi += 1
        tokens, lengths, _ = _encode_padded(self.tokenizer, texts,
                                            self.max_len)
        batch = {
            "tokens": tokens,
            "text_len": lengths,
            "pos_label": pos_label,
            "img_index": _grid_img_index(b, n, "i2t"),
        }
        batch.update(self._image_pools(
            [[self.store.index_of(img_id)] for img_id in anchor_ids]))
        return batch

    def pretrain_batch(self, rng, anchor_ids: List[str], direction: str,
                       with_clcm: bool = False) -> Batch:
        # _grid_batch already carries per-row obj_labels + raw_feats for
        # MC-MRM / MRFR; MCT for pretraining uses dclag variants below
        batch = self._grid_batch(rng, anchor_ids, direction)
        n = self.sample_n
        if with_clcm:
            texts, labels = [], []
            ids = list(self.captions.keys())
            for img_id in anchor_ids:
                caps = self.captions[img_id]
                a = caps[rng.randint(len(caps))]
                for _ in range(n):
                    if rng.random_sample() < 0.5:
                        b = self.captions[ids[rng.randint(len(ids))]]
                        other = b[rng.randint(len(b))]
                        labels.append(0)
                    else:
                        other = caps[rng.randint(len(caps))]
                        labels.append(1)
                    texts.append(a + " " + other)
            toks, lens, _ = _encode_padded(self.tokenizer, texts,
                                           2 * self.max_len)
            batch["clcm_tokens"] = toks
            batch["clcm_len"] = lens
            batch["clcm_labels"] = np.array(labels, np.int32)
        return batch

    def epoch_iterator(self, batch_size: int, epoch: int = 0,
                       with_clcm: bool = False):
        self.update(epoch)
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(len(self.image_ids))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            ids = [self.image_ids[i] for i in order[start:start + batch_size]]
            yield (self.pretrain_batch(rng, ids, "t2i"),
                   self.pretrain_batch(rng, ids, "i2t", with_clcm=with_clcm))


class MILDDataset(RetrievalDataset):
    """MILD query-based retrieval (`MILD_finetune.py:33-975`): items are
    (query, passage) pairs per image; ``qp_type='q'`` scores the query alone,
    ``qp_type='qp'`` scores query+passage concatenated
    (`MILD_finetune.py:110-113,944-974`).  Candidate-grid semantics are
    inherited from RetrievalDataset with the text built per qp_type.
    """

    def __init__(self, queries: Dict[str, List[Tuple[str, str]]], store,
                 tokenizer, qp_type: str = "q", **kw):
        assert qp_type in ("q", "qp")
        self.qp_type = qp_type
        captions = {
            img_id: [q if qp_type == "q" else f"{q} </s> {p}"
                     for q, p in pairs]
            for img_id, pairs in queries.items()}
        super().__init__(captions, store, tokenizer, **kw)


class CaptionDataset:
    """(caption, image) pairs for captioning / tifg (`dataset_finetune.py:
    32-297`)."""

    def __init__(self, captions: Dict[str, List[str]],
                 store: RegionFeatureStore, tokenizer, lang: str = "en",
                 max_len: int = 64, clager: Optional[Clager] = None,
                 seed: int = 0, region_noise: bool = False,
                 lang_id: Optional[int] = None):
        self.captions = captions
        self.store = store
        self.tokenizer = tokenizer
        self.lang = lang
        # the reference trains the caption decoder WITH language embeddings
        # (`ic_step`: ``langs = x2.clone().fill_(lang1_id)``,
        # `xtrainer.py:1464-1470`) and decodes with the same lang id; when
        # ``lang_id`` is set, batches carry a matching ``langs`` plane so the
        # train-time and decode-time (`tgt_lang_id`) embeddings agree.
        self.lang_id = lang_id
        self.max_len = max_len
        self.clager = clager
        self.seed = seed
        # IDA / bart_img: Poisson object-span noise on the input features
        # (`bart_img_step`, `xtrainer.py:1746`)
        self.region_noise = region_noise
        self.items: List[Tuple[str, str]] = [
            (img_id, cap) for img_id, caps in captions.items()
            for cap in caps]

    def __len__(self) -> int:
        return len(self.items)

    def epoch_iterator(self, batch_size: int, epoch: int = 0,
                       shuffle: bool = True,
                       drop_last: bool = True) -> Iterator[Batch]:
        """``drop_last=False`` yields a short final batch (one extra
        shape) — REQUIRED for generation eval, where dropping the remainder
        would silently skip up to batch_size-1 test images (and all of
        them when the test set is smaller than one batch); training keeps
        the static-shape default."""
        rng = np.random.RandomState(self.seed + epoch)
        order = (rng.permutation(len(self.items)) if shuffle
                 else np.arange(len(self.items)))
        stop = len(order) - batch_size + 1 if drop_last else len(order)
        for start in range(0, stop, batch_size):
            img_ids, texts = [], []
            for i in order[start:start + batch_size]:
                img_id, cap = self.items[i]
                if self.clager is not None:
                    cap = self.clager.clag(rng, cap, self.lang)
                img_ids.append(img_id)
                texts.append(cap)
            tokens, lengths, _ = _encode_padded(self.tokenizer, texts,
                                                self.max_len)
            region = [self.store.get(self.store.index_of(i)) for i in img_ids]
            feats = np.stack([r["feats"] for r in region])
            img_len = np.array([r["mask"].sum() for r in region], np.int32)
            if self.region_noise:
                from m3p_tpu_torch.data.span_masking import poisson_region_noise

                feats = poisson_region_noise(rng, feats, img_len)
            out = {
                "tokens": tokens,
                "tgt_len": lengths,
                "feats": feats,
                "locs": np.stack([r["locs"] for r in region]),
                "img_len": img_len,
            }
            if self.lang_id is not None:
                out["langs"] = np.full_like(tokens, self.lang_id)
            yield out


class PretrainCaptionDataset(CaptionDataset):
    """Pre-training caption stream over sharded CC/SBU corpora — the caption
    counterpart of PretrainDataset (`VLMPretrainCapDataset`,
    `dataset_pretrain.py:507-784`): same per-epoch / per-feeder shard
    schedule, one (caption, image) pair per item, MCT via `clager.clag`."""

    def __init__(self, shards: Sequence[RegionFeatureStore],
                 captions_per_shard: Sequence[Dict[str, List[str]]],
                 tokenizer, train_order: Optional[Sequence[Sequence[int]]] = None,
                 n_feeders: int = 1, feeder_id: int = 0, **kw):
        self.shards = list(shards)
        self.captions_per_shard = list(captions_per_shard)
        self.train_order = train_order
        self.n_feeders = n_feeders
        self.feeder_id = feeder_id
        super().__init__(captions_per_shard[0], shards[0], tokenizer, **kw)
        self.update(0)

    def update(self, epoch: int) -> None:
        shard_idx = _shard_for_epoch(self.train_order, epoch, self.feeder_id,
                                     self.n_feeders, len(self.shards))
        self.store = self.shards[shard_idx]
        self.captions = self.captions_per_shard[shard_idx]
        self.items = [(img_id, cap) for img_id, caps in self.captions.items()
                      for cap in caps]

    def epoch_iterator(self, batch_size: int, epoch: int = 0,
                       shuffle: bool = True):
        self.update(epoch)
        yield from super().epoch_iterator(batch_size, epoch, shuffle)


class StreamDataset:
    """XLM-style continuous token stream reshaped to (bs, bptt) blocks with a
    resumable shuffled iterator (`dataset_pretrain.py:787-891`)."""

    def __init__(self, token_stream: np.ndarray, bptt: int = 128,
                 seed: int = 0, n_feeders: int = 1, feeder_id: int = 0):
        stream = np.asarray(token_stream, np.int32).reshape(-1)
        n_blocks = len(stream) // bptt
        self.blocks = stream[: n_blocks * bptt].reshape(n_blocks, bptt)
        # per-feeder subselect (`loader.py:409-413`)
        self.blocks = self.blocks[feeder_id::n_feeders]
        self.bptt = bptt
        self.seed = seed
        self.position = 0  # resumable cursor (reload counter equivalent)

    def __len__(self) -> int:
        return len(self.blocks)

    def state_dict(self) -> Dict[str, int]:
        return {"position": self.position}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.position = int(state["position"])

    def epoch_iterator(self, batch_size: int, epoch: int = 0
                       ) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(len(self.blocks))
        while self.position + batch_size <= len(order):
            idx = order[self.position:self.position + batch_size]
            self.position += batch_size
            yield {
                "tokens": self.blocks[idx],
                "lengths": np.full((batch_size,), self.bptt, np.int32),
            }
        self.position = 0


class NoisedStreamDataset(StreamDataset):
    """Stream dataset whose batches pass through a host noise transform —
    the feed for MASS (`restricted_mask_sent`, `xtrainer.py:1269-1316`),
    BART infilling (`bart_token_mask_sent`, :1318-1381) and denoising-AE
    word noise (`xtrainer.py:291-383`) objectives.

    ``transform(rng, batch, lang_id) -> batch`` (see
    `data/loader.py::make_mass_transform` etc.).
    """

    def __init__(self, token_stream: np.ndarray, transform,
                 lang_id: Optional[int] = None, **kw):
        super().__init__(token_stream, **kw)
        self.transform = transform
        self.lang_id = lang_id

    def epoch_iterator(self, batch_size: int, epoch: int = 0
                       ) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed * 7 + epoch + 101)
        for batch in super().epoch_iterator(batch_size, epoch):
            yield self.transform(rng, batch, self.lang_id)


class PCDataset:
    """Parallel classification (`pc_step`, `xtrainer.py:772-826`): classify
    whether a concatenated sentence pair is a translation pair.  Half the
    rows keep the aligned target (label 1), half get a random other target
    (label 0); pairs concatenate TLM-style with per-side language ids
    (`concat_batches`, `utils.py:324-362`)."""

    def __init__(self, src_texts: Sequence[str], tgt_texts: Sequence[str],
                 tokenizer, max_len: int = 64, seed: int = 0,
                 src_lang_id: int = 0, tgt_lang_id: int = 1):
        assert len(src_texts) == len(tgt_texts)
        self.src_texts = list(src_texts)
        self.tgt_texts = list(tgt_texts)
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.seed = seed
        self.src_lang_id = src_lang_id
        self.tgt_lang_id = tgt_lang_id

    def __len__(self) -> int:
        return len(self.src_texts)

    def epoch_iterator(self, batch_size: int, epoch: int = 0
                       ) -> Iterator[Batch]:
        from m3p_tpu_torch.data.noise import concat_batches

        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(len(self.src_texts))
        width = 2 * self.max_len - 1  # fixed concat width (static shapes)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            labels = (rng.rand(batch_size) < 0.5).astype(np.int32)
            src = [self.src_texts[i] for i in idx]
            tgt = [self.tgt_texts[i] if labels[j] else
                   self.tgt_texts[order[rng.randint(len(order))]]
                   for j, i in enumerate(idx)]
            s_toks, s_len, _ = _encode_padded(self.tokenizer, src,
                                              self.max_len)
            t_toks, t_len, _ = _encode_padded(self.tokenizer, tgt,
                                              self.max_len)
            toks, lens, pos, langs = concat_batches(
                s_toks, s_len, self.src_lang_id, t_toks, t_len,
                self.tgt_lang_id)
            out_toks = np.full((batch_size, width), PAD_IDX, toks.dtype)
            out_pos = np.zeros((batch_size, width), pos.dtype)
            out_langs = np.zeros((batch_size, width), langs.dtype)
            w = toks.shape[1]
            out_toks[:, :w] = toks
            out_pos[:, :w] = pos
            out_langs[:, :w] = langs
            yield {"tokens": out_toks, "lengths": lens,
                   "positions": out_pos, "langs": out_langs,
                   "labels": labels}


class ParallelDataset:
    """Src/tgt sentence pairs for MT and NTG, length-grouped batching
    (`MT_finetune.py`, `NTG_xlm_based.py:23-173`)."""

    def __init__(self, src_texts: Sequence[str], tgt_texts: Sequence[str],
                 tokenizer, max_len: int = 64, seed: int = 0,
                 src_lang_id: Optional[int] = None,
                 tgt_lang_id: Optional[int] = None,
                 store: Optional[RegionFeatureStore] = None,
                 image_ids: Optional[Sequence[str]] = None,
                 group_by_size: bool = True):
        assert len(src_texts) == len(tgt_texts)
        self.src_texts = list(src_texts)
        self.tgt_texts = list(tgt_texts)
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.seed = seed
        self.src_lang_id = src_lang_id
        self.tgt_lang_id = tgt_lang_id
        self.store = store              # set -> multimodal MT triples
        self.image_ids = list(image_ids) if image_ids is not None else None
        self.group_by_size = group_by_size  # `--group_by_size`

    def __len__(self) -> int:
        return len(self.src_texts)

    def epoch_iterator(self, batch_size: int, epoch: int = 0,
                       shuffle: bool = True) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed + epoch)
        # length-grouped then shuffled in chunks (NTG convention); plain
        # shuffled order when --group_by_size False
        if self.group_by_size:
            order = np.argsort([len(s) for s in self.src_texts],
                               kind="stable")
        else:
            order = (rng.permutation(len(self.src_texts)) if shuffle
                     else np.arange(len(self.src_texts)))
        n_batches = len(order) // batch_size
        batch_order = (rng.permutation(n_batches) if shuffle
                       else np.arange(n_batches))
        for bi in batch_order:
            idx = order[bi * batch_size:(bi + 1) * batch_size]
            src = [self.src_texts[i] for i in idx]
            tgt = [self.tgt_texts[i] for i in idx]
            s_toks, s_len, s_langs = _encode_padded(
                self.tokenizer, src, self.max_len,
                [self.src_lang_id] * len(idx)
                if self.src_lang_id is not None else None)
            t_toks, t_len, t_langs = _encode_padded(
                self.tokenizer, tgt, self.max_len,
                [self.tgt_lang_id] * len(idx)
                if self.tgt_lang_id is not None else None)
            batch = {"src_tokens": s_toks, "src_len": s_len,
                     "tgt_tokens": t_toks, "tgt_len": t_len}
            if s_langs is not None:
                batch["src_langs"] = s_langs
            if t_langs is not None:
                batch["tgt_langs"] = t_langs
            if self.store is not None:
                region = [self.store.get(self.store.index_of(
                    self.image_ids[i])) for i in idx]
                batch["feats"] = np.stack([r["feats"] for r in region])
                batch["locs"] = np.stack([r["locs"] for r in region])
                batch["img_len"] = np.array(
                    [r["mask"].sum() for r in region], np.int32)
            yield batch


class SlideDataset:
    """Slide-text matching with explicit pos/neg pools and binary labels
    (`SLIDE_finetune.py:32-259`)."""

    def __init__(self, items: Sequence[Tuple[str, str, int]],
                 store: RegionFeatureStore, tokenizer, max_len: int = 64,
                 seed: int = 0):
        """items: (image_id, text, label) triples."""
        self.items = list(items)
        self.store = store
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.seed = seed

    def __len__(self) -> int:
        return len(self.items)

    def epoch_iterator(self, batch_size: int, epoch: int = 0
                       ) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(len(self.items))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            texts = [self.items[i][1] for i in idx]
            tokens, lengths, _ = _encode_padded(self.tokenizer, texts,
                                                self.max_len)
            region = [self.store.get(self.store.index_of(self.items[i][0]))
                      for i in idx]
            yield {
                "tokens": tokens,
                "text_len": lengths,
                "feats": np.stack([r["feats"] for r in region]),
                "locs": np.stack([r["locs"] for r in region]),
                "img_len": np.array([r["mask"].sum() for r in region],
                                    np.int32),
                "labels": np.array([self.items[i][2] for i in idx], np.int32),
            }


def build_eval_retrieval_arrays(
    captions: Dict[str, List[str]],
    store: RegionFeatureStore,
    tokenizer,
    max_len: int = 64,
    caps_per_image: int = 5,
):
    """Flatten an eval split into the arrays `retrieval_grid_scores` consumes:
    (cap_tokens, cap_len, cap_to_img, img_feats, img_locs, img_len).

    Mirrors `EvaluateRetrievalDataset.precess_reload`
    (`dataset_finetune.py:1078-1178`): all captions of all images, gold
    mapping caption -> image index.
    """
    image_ids = list(captions.keys())
    texts, cap_to_img = [], []
    for i, img_id in enumerate(image_ids):
        for cap in captions[img_id][:caps_per_image]:
            texts.append(cap)
            cap_to_img.append(i)
    toks, lens, _ = _encode_padded(tokenizer, texts, max_len)
    region = [store.get(store.index_of(i)) for i in image_ids]
    return (toks, lens, np.array(cap_to_img, np.int64),
            np.stack([r["feats"] for r in region]),
            np.stack([r["locs"] for r in region]),
            np.array([r["mask"].sum() for r in region], np.int32))
