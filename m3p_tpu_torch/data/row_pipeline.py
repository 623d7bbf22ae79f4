"""The port's checkpointable row loader (counterpart of
`m3p_tpu/data/grain_pipeline.py`), on numpy and threads, without grain.

Every dataset family gets a random-access row source: record ``key`` is
built by the family's row function from its own
``RandomState((seed * 1000003 + key) % 2**32)``, so a record is a pure
function of (seed, key), the same arrays as the JAX `RowSource` gives for
the key.  `make_row_loader` lays the records out as the JAX loader's grain
pipeline does (``MapDataset.source(...).shuffle(seed + epoch)
.repeat(num_epochs).batch(batch_size, drop_remainder=True)``):

  * pass ``e`` of the repeat visits position ``i`` at the record
    `index_shuffle` ``(i, n - 1, seed + epoch + e)`` gives, grain's
    permutation (a copy of its C++ ``index_shuffle``: a Simon-like Feistel
    network over ``std::seed_seq`` round keys, cycle-walked into
    ``[0, n)``);
  * batch ``b`` holds positions ``b * batch_size`` to ``(b + 1) *
    batch_size - 1`` over the passes laid end to end; a short last batch is
    dropped.

So a batch is a function of (seed, epoch, batch index) alone, and so is
the iterator's position: `save_loader_state` writes it as a JSON string and
`restore_loader_state` seeks there.  ``worker_count`` threads build the
records ahead of the consumer (numpy's big copies, h5py and the
tokenizer's Python code interleave); they change when a record is built,
never which records a batch holds.

Several batch shards (``shard=(index, count)``): the records are sliced
before the shuffle, ``index, index + count, ...``, as the JAX loader slices
them by process (`m3p_tpu/data/grain_pipeline.py:278-282`): disjoint, and
balanced to within one record.  With ``count`` 1 every record goes to this
process's batches.
"""

from __future__ import annotations

import collections
import json
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from m3p_tpu_torch.data.datasets import (
    CaptionDataset, ParallelDataset, PCDataset, PretrainDataset,
    RetrievalDataset, SlideDataset, StreamDataset, _encode_padded)
from m3p_tpu_torch.data.noise import concat_batches
from m3p_tpu_torch.data.span_masking import poisson_region_noise

logger = logging.getLogger("m3p_tpu_torch")

_STATE_FORMAT = "m3p_tpu_torch.row_loader/1"


# ---------------------------------------------------------------------------
# grain's shuffle order
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# the smallest Feistel block grain's index_shuffle uses, in bits
_MIN_BLOCK_BITS = 16


def _seed_seq_words(seed: int, n: int):
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    v = [seed & _M32]
    s = len(v)
    out = [0x8b8b8b8b] * n
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39
         else 3 if n >= 7 else (n - 1) // 2)
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n]
                            ^ out[(k - 1) % n])) & _M32
        r2 = (r1 + (s if k == 0 else (k % n + v[k - 1]) if k <= s
                    else k % n)) & _M32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _M32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _M32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n]
                                + out[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def _encrypt(block: np.ndarray, keys, half: int) -> np.ndarray:
    """One pass of grain's ``simon_encrypt<half>`` over uint64 blocks of
    2 * ``half`` bits: per key pair, x ^= f(y) ^ k0, then y ^= f(x) ^ k1,
    with f(v) = (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2) on ``half``-bit
    words."""
    mask = np.uint64((1 << half) - 1)

    def rotl(v, r):
        r %= half
        if r == 0:
            return v
        return ((v << np.uint64(r)) | (v >> np.uint64(half - r))) & mask

    def f(v):
        return (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2)

    x = (block >> np.uint64(half)) & mask
    y = block & mask
    for i in range(0, len(keys), 2):
        x = x ^ f(y) ^ np.uint64(keys[i] & int(mask))
        y = y ^ f(x) ^ np.uint64(keys[i + 1] & int(mask))
    return (x << np.uint64(half)) | y


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4
                  ) -> np.ndarray:
    """Grain's ``index_shuffle(index, max_index, seed, rounds)`` over an
    array of indices: the position each index of ``[0, max_index]`` moves
    to (int64)."""
    index = np.asarray(index, np.int64)
    if max_index == 0:
        return np.zeros_like(index)
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, not {rounds}")
    bits = int(math.ceil(math.log2(max_index)))
    bits = max(bits + bits % 2, _MIN_BLOCK_BITS)
    if bits > 64:
        raise ValueError(f"max_index {max_index} needs {bits} bits")
    keys = _seed_seq_words(seed, rounds)
    half = bits // 2
    if bits == _MIN_BLOCK_BITS:
        # a block far wider than the range (small max_index) makes long
        # walks: walk the block's whole permutation at once instead, by
        # pointer jumping (each pass halves the steps left), to the first
        # value in range along each index's cycle
        nxt = _encrypt(np.arange(1 << bits, dtype=np.uint64), keys,
                       half).astype(np.int64)
        done = nxt <= max_index
        start = index & ((1 << bits) - 1)
        while not done[start].all():
            todo = np.flatnonzero(~done)
            via = nxt[todo]
            nxt[todo] = nxt[via]
            done[todo] = done[via]
        return nxt[start]
    out = _encrypt(index.astype(np.uint64), keys, half)
    # cycle-walk every value past max_index back into the range (a block
    # at most 4x the range: a few passes)
    walk = np.flatnonzero(out > np.uint64(max_index))
    while walk.size:
        out[walk] = _encrypt(out[walk], keys, half)
        walk = walk[out[walk] > np.uint64(max_index)]
    return out.astype(np.int64)


# ---------------------------------------------------------------------------
# row sources
# ---------------------------------------------------------------------------


class RowSource:
    """Random-access records: ``row_fn(rng, index) -> dict`` of per-row
    arrays, ``rng`` drawn from ``(seed, key)`` alone."""

    def __init__(self, n: int, seed: int, row_fn: Callable):
        self._n = n
        self._seed = seed
        self._row_fn = row_fn

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, record_key: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self._seed * 1000003 + record_key) % (2 ** 32))
        return self._row_fn(rng, record_key % self._n)

    def __repr__(self) -> str:
        # a saved position is restored only into a loader over this source
        return (f"RowSource(n={self._n}, seed={self._seed}, "
                f"row={getattr(self._row_fn, '__qualname__', 'row')})")


class StridedSource:
    """Records ``index, index + count, ...`` of a source: grain's
    ``MapDataset.slice(slice(index, None, count))``."""

    def __init__(self, source: RowSource, index: int, count: int):
        if not 0 <= index < count:
            raise ValueError(f"shard {index} of {count}")
        self.source, self.index, self.count = source, index, count

    def __len__(self) -> int:
        return len(range(self.index, len(self.source), self.count))

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.source[self.index + i * self.count]

    def __repr__(self) -> str:
        return f"{self.source!r}[{self.index}::{self.count}]"


def _stack_batch(rows):
    """Per-row dicts -> one dict of stacked arrays (grain's default
    batch function)."""
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _grid_batch_fn(rows) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Per-anchor {"t2i": grid, "i2t": grid} records -> the grid-flattened
    (t2i, i2t) batch pair the `Trainer` steps.  A record's grid leaves
    carry the rows of its group first, so batching concatenates."""
    out = []
    for key in ("t2i", "i2t"):
        out.append({leaf: np.concatenate([r[key][leaf] for r in rows], axis=0)
                    for leaf in rows[0][key]})
    return tuple(out)


def _grid_pair_source(ds: RetrievalDataset, seed: int,
                      with_clcm: bool = False) -> RowSource:
    """One record = one anchor image's (t2i, i2t) grid pair."""

    def row(rng, i):
        img_id = ds.image_ids[i]
        if isinstance(ds, PretrainDataset):
            t2i = ds.pretrain_batch(rng, [img_id], "t2i")
            i2t = ds.pretrain_batch(rng, [img_id], "i2t",
                                    with_clcm=with_clcm)
        else:
            t2i = ds._grid_batch(rng, [img_id], "t2i")
            i2t = ds._grid_batch(rng, [img_id], "i2t")
        return {"t2i": t2i, "i2t": i2t}

    return RowSource(len(ds.image_ids), seed, row)


def _caption_source(ds: CaptionDataset, seed: int) -> RowSource:
    def row(rng, i):
        img_id, cap = ds.items[i]
        if ds.clager is not None:
            cap = ds.clager.clag(rng, cap, ds.lang)
        tokens, lengths, _ = _encode_padded(ds.tokenizer, [cap], ds.max_len)
        r = ds.store.get(ds.store.index_of(img_id))
        feats = r["feats"][None]
        img_len = np.array([r["mask"].sum()], np.int32)
        if ds.region_noise:
            feats = poisson_region_noise(rng, feats, img_len)
        return {"tokens": tokens[0], "tgt_len": lengths[0],
                "feats": feats[0], "locs": r["locs"],
                "img_len": img_len[0]}

    return RowSource(len(ds.items), seed, row)


def _slide_source(ds: SlideDataset, seed: int) -> RowSource:
    def row(rng, i):
        img_id, text, label = ds.items[i]
        tokens, lengths, _ = _encode_padded(ds.tokenizer, [text], ds.max_len)
        r = ds.store.get(ds.store.index_of(img_id))
        return {"tokens": tokens[0], "text_len": lengths[0],
                "feats": r["feats"], "locs": r["locs"],
                "img_len": np.int32(r["mask"].sum()),
                "labels": np.int32(label)}

    return RowSource(len(ds.items), seed, row)


def _parallel_source(ds: ParallelDataset, seed: int) -> RowSource:
    def row(rng, i):
        s_toks, s_len, s_langs = _encode_padded(
            ds.tokenizer, [ds.src_texts[i]], ds.max_len,
            [ds.src_lang_id] if ds.src_lang_id is not None else None)
        t_toks, t_len, t_langs = _encode_padded(
            ds.tokenizer, [ds.tgt_texts[i]], ds.max_len,
            [ds.tgt_lang_id] if ds.tgt_lang_id is not None else None)
        out = {"src_tokens": s_toks[0], "src_len": s_len[0],
               "tgt_tokens": t_toks[0], "tgt_len": t_len[0]}
        if s_langs is not None:
            out["src_langs"] = s_langs[0]
        if t_langs is not None:
            out["tgt_langs"] = t_langs[0]
        if ds.store is not None:
            r = ds.store.get(ds.store.index_of(ds.image_ids[i]))
            out["feats"] = r["feats"]
            out["locs"] = r["locs"]
            out["img_len"] = np.int32(r["mask"].sum())
        return out

    return RowSource(len(ds.src_texts), seed, row)


def _pc_source(ds: PCDataset, seed: int) -> RowSource:
    def row(rng, i):
        label = np.int32(rng.rand() < 0.5)
        j = i if label else rng.randint(len(ds.tgt_texts))
        s_toks, s_len, _ = _encode_padded(ds.tokenizer, [ds.src_texts[i]],
                                          ds.max_len)
        t_toks, t_len, _ = _encode_padded(ds.tokenizer, [ds.tgt_texts[j]],
                                          ds.max_len)
        toks, lens, pos, langs = concat_batches(
            s_toks, s_len, ds.src_lang_id, t_toks, t_len, ds.tgt_lang_id)
        width = 2 * ds.max_len - 1
        out_t = np.full((width,), 1, toks.dtype)  # PAD
        out_p = np.zeros((width,), pos.dtype)
        out_l = np.zeros((width,), langs.dtype)
        w = toks.shape[1]
        out_t[:w] = toks[0]
        out_p[:w] = pos[0]
        out_l[:w] = langs[0]
        return {"tokens": out_t, "lengths": lens[0], "positions": out_p,
                "langs": out_l, "labels": label}

    return RowSource(len(ds.src_texts), seed, row)


def _stream_source(ds: StreamDataset, seed: int) -> RowSource:
    transform = getattr(ds, "transform", None)
    lang_id = getattr(ds, "lang_id", None)

    def row(rng, i):
        block = ds.blocks[i]
        batch = {"tokens": block[None],
                 "lengths": np.array([ds.bptt], np.int32)}
        if transform is not None:
            batch = transform(rng, batch, lang_id)
        return {k: v[0] for k, v in batch.items()}

    return RowSource(len(ds.blocks), seed, row)


# ---------------------------------------------------------------------------
# the loader and its position
# ---------------------------------------------------------------------------


def supports_grain(dataset) -> bool:
    """Whether `make_row_loader` has a row source for the dataset (the
    JAX package's name for the same test)."""
    return isinstance(dataset, (RetrievalDataset, CaptionDataset,
                                SlideDataset, ParallelDataset, PCDataset,
                                StreamDataset))


class RowLoader:
    """The batches of a row source in grain's order (module docstring);
    ``iter()`` gives a `RowIterator` from the first batch."""

    def __init__(self, source: RowSource, batch_size: int, shuffle_seed: int,
                 num_epochs: Optional[int] = 1,
                 batch_fn: Callable = _stack_batch, worker_count: int = 1,
                 prefetch: int = 128):
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size}")
        if not 0 <= shuffle_seed < 2 ** 32:
            raise ValueError(f"shuffle seed {shuffle_seed} outside "
                             f"[0, 2**32)")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError(f"num_epochs {num_epochs}")
        self.source = source
        self.batch_size = batch_size
        self.shuffle_seed = shuffle_seed
        self.num_epochs = num_epochs
        self.batch_fn = batch_fn
        self.worker_count = max(1, worker_count)
        self.prefetch = max(prefetch, batch_size)

    @property
    def n_batches(self) -> Optional[int]:
        """Batches over all passes; None for an endless repeat."""
        if self.num_epochs is None:
            return None if len(self.source) else 0
        return self.num_epochs * len(self.source) // self.batch_size

    def __iter__(self) -> "RowIterator":
        return RowIterator(self)

    def state(self, next_batch: int) -> dict:
        return {"format": _STATE_FORMAT, "source": repr(self.source),
                "batch_size": self.batch_size,
                "shuffle_seed": self.shuffle_seed,
                "num_epochs": self.num_epochs, "next_batch": int(next_batch)}


class RowIterator:
    """Batches of a `RowLoader` from a position, its records built ahead by
    the loader's read threads.  ``start`` is where the iterator began (0, or
    the restored position); ``position`` is the next batch it yields."""

    def __init__(self, loader: RowLoader):
        self.loader = loader
        self.start = 0
        self.position = 0
        self._orders: Dict[int, np.ndarray] = {}
        self._pending: "collections.OrderedDict" = collections.OrderedDict()
        self._next_submit = 0
        self._pool = ThreadPoolExecutor(
            max_workers=loader.worker_count,
            thread_name_prefix="m3p-row-loader")

    def _order(self, e: int) -> np.ndarray:
        """Pass ``e``'s permutation of the records (the last two kept)."""
        if e not in self._orders:
            n = len(self.loader.source)
            seed = (self.loader.shuffle_seed + e) % 2 ** 32
            self._orders[e] = index_shuffle(np.arange(n), n - 1, seed)
            for old in [k for k in self._orders if k < e - 1]:
                del self._orders[old]
        return self._orders[e]

    def _record_end(self) -> Optional[int]:
        n_batches = self.loader.n_batches
        return None if n_batches is None else n_batches * self.loader.batch_size

    def _fill(self, upto: int) -> None:
        """Submit the records of positions up to ``upto`` (exclusive)."""
        end = self._record_end()
        if end is not None:
            upto = min(upto, end)
        n = len(self.loader.source)
        source = self.loader.source
        while self._next_submit < upto:
            pos = self._next_submit
            key = int(self._order(pos // n)[pos % n])
            self._pending[pos] = self._pool.submit(source.__getitem__, key)
            self._next_submit += 1

    def _drop_pending(self) -> None:
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()

    def __iter__(self):
        return self

    def __next__(self):
        n_batches = self.loader.n_batches
        if n_batches is not None and self.position >= n_batches:
            raise StopIteration
        bs = self.loader.batch_size
        first = self.position * bs
        self._fill(first + bs + self.loader.prefetch)
        rows = [self._pending.pop(pos).result()
                for pos in range(first, first + bs)]
        self.position += 1
        return self.loader.batch_fn(rows)

    def get_state(self, consumed: Optional[int] = None) -> dict:
        """The position after ``consumed`` batches from ``start``; by
        default, after the batches this iterator yielded."""
        at = self.position if consumed is None else self.start + consumed
        return self.loader.state(at)

    def set_state(self, state: dict) -> None:
        want = self.loader.state(0)
        if not isinstance(state, dict):
            raise ValueError(f"loader state {state!r} is not a dict")
        for key in ("format", "source", "batch_size", "shuffle_seed",
                    "num_epochs"):
            if state.get(key) != want[key]:
                raise ValueError(
                    f"loader state's {key} {state.get(key)!r} is not this "
                    f"loader's {want[key]!r}")
        at = state.get("next_batch")
        n_batches = self.loader.n_batches
        if not isinstance(at, int) or at < 0 or (
                n_batches is not None and at > n_batches):
            raise ValueError(f"loader state's next_batch {at!r} outside "
                             f"[0, {n_batches}]")
        self._drop_pending()
        self.start = self.position = at
        self._next_submit = at * self.loader.batch_size

    def close(self) -> None:
        """Stop the read threads; records in flight are dropped."""
        self._drop_pending()
        self._pool.shutdown(wait=False, cancel_futures=True)


def make_row_loader(dataset, batch_size: int, seed: int = 0, epoch: int = 0,
                    with_clcm: bool = False,
                    num_epochs: Optional[int] = 1,
                    worker_count: int = 1,
                    shard: Tuple[int, int] = (0, 1)) -> RowLoader:
    """The row loader of any supported dataset family (`make_grain_loader`
    of the JAX package); ``shard`` = (index, count) takes the strided
    slice of the records of batch shard ``index`` (module docstring).

    Grid datasets (retrieval / pretrain / MILD) yield (t2i, i2t) batch
    pairs of BN = batch_size * sample_n rows; row datasets yield batch
    dicts.  The shard-scheduled datasets (`PretrainDataset`,
    `PretrainCaptionDataset`) switch to the epoch's shard here.
    ``worker_count`` sizes the read-thread pool; it does not change which
    records a batch holds."""
    row_seed = seed * 31 + epoch
    batch_fn = _stack_batch
    if isinstance(dataset, RetrievalDataset):  # incl. Pretrain/MILD
        if isinstance(dataset, PretrainDataset):
            dataset.update(epoch)
        source = _grid_pair_source(dataset, row_seed, with_clcm)
        batch_fn = _grid_batch_fn
    elif isinstance(dataset, CaptionDataset):
        if hasattr(dataset, "update"):   # PretrainCaptionDataset shards
            dataset.update(epoch)
        source = _caption_source(dataset, row_seed)
    elif isinstance(dataset, SlideDataset):
        source = _slide_source(dataset, row_seed)
    elif isinstance(dataset, PCDataset):
        source = _pc_source(dataset, row_seed)
    elif isinstance(dataset, ParallelDataset):
        source = _parallel_source(dataset, row_seed)
    elif isinstance(dataset, StreamDataset):  # incl. NoisedStreamDataset
        source = _stream_source(dataset, row_seed)
    else:
        raise TypeError(f"no row source for {type(dataset).__name__}")
    if shard[1] > 1:
        source = StridedSource(source, *shard)
    if worker_count > 4:
        logger.warning(
            "worker_count=%d read threads: past 4, the threads mostly "
            "contend for the GIL while they assemble rows; measure the "
            "loader's records/s before using more", worker_count)
    logger.info("row loader: %s n=%d bs=%d read_threads=%d",
                type(dataset).__name__, len(source), batch_size,
                max(1, worker_count))
    # a small record window: a flagship grid record holds five images of
    # 100 x 2048 fp32 features, about 4 MB
    return RowLoader(source, batch_size, (seed + epoch) % 2 ** 32,
                     num_epochs=num_epochs, batch_fn=batch_fn,
                     worker_count=worker_count,
                     prefetch=min(4 * batch_size, 128))


def save_loader_state(iterator: RowIterator,
                      consumed: Optional[int] = None) -> str:
    """A `RowIterator`'s position as a JSON string: after the batches it
    yielded, or after ``consumed`` batches from where it began (a consumer
    that stages batches ahead counts the ones its steps took)."""
    return json.dumps(iterator.get_state(consumed))


def restore_loader_state(iterator: RowIterator, state) -> None:
    """Seek ``iterator`` to a position `save_loader_state` wrote.  Raises
    ValueError for a state this loader cannot read (another format, source,
    batch size, seed or length), which the `Trainer` answers by starting
    the iterator at the epoch's head."""
    if isinstance(state, str):
        try:
            state = json.loads(state)
        except json.JSONDecodeError as e:
            raise ValueError(f"loader state is not JSON: {e}") from e
    iterator.set_state(state)
