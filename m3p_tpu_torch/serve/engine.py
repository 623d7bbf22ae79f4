"""Inference engine of the port (counterpart of `m3p_tpu/serve/engine.py`).

* Requests are padded to the same (batch, text) buckets as in the JAX
  engine and results sliced back, so a pair scores the same in any batch.
* The model lives on the engine's device; forward passes run under
  ``torch.inference_mode()`` and one lock, so concurrent request threads
  queue for the device instead of interleaving on its stream.
* A retrieval gallery is staged on the device once; a query ships only its
  tokens, and each chunk of the gallery is gathered there with
  ``index_select``.
* Captioning and translation decode with the generation module
  (`model/generation.py`: beam search by default, greedy at beam 1) over
  `encode_image` (the refiner when ``refine_image``) or `encode_text`, in
  the same batch buckets as the JAX engine.
* ``image_id`` payloads are read from an attached feature store
  (`attach_store`: an h5 `data.features.RegionFeatureStore`, or any object
  with its ``get``, ``index_of`` and ``image_ids``, set as ``engine.store``);
  `load_gallery_from_store` stages its first images as the gallery.
* A model built with ``int8_infer`` (``from_checkpoint(quant="int8")``)
  has its frozen-weight int8 tables captured once at construction
  (`model.capture_q8`); the same checkpoint serves either way.
"""

from __future__ import annotations

import bisect
import dataclasses
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from m3p_tpu_torch.config import PAD_IDX
from m3p_tpu_torch.data.features import l2_normalize, norm_boxes
from m3p_tpu_torch.model import capture_q8, lengths_to_mask, resolve_device
from m3p_tpu_torch.model.generation import beam_search, greedy_generate
from m3p_tpu_torch.tokenization.tokenizer import batch_sentences

logger = logging.getLogger("m3p_tpu_torch")

DEFAULT_TEXT_BUCKETS = (16, 32, 64)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket caps the value; callers chunk
    anything bigger)."""
    i = bisect.bisect_left(buckets, n)
    return buckets[min(i, len(buckets) - 1)]


class InferenceEngine:
    """Batched ITM scoring, retrieval, captioning and translation over an
    M3P model."""

    def __init__(self, model, tokenizer=None, *,
                 device: Union[str, torch.device] = "cuda",
                 max_regions: int = 100,
                 text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 refine_image: bool = True,
                 beam_size: int = 5,
                 max_gen_len: int = 20,
                 length_penalty: float = 1.0,
                 lang2id: Optional[Dict[str, int]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.feat_dim = int(model.cfg.img_feat_dim)
        self.max_regions = int(max_regions)
        self.text_buckets = tuple(sorted(text_buckets))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.refine_image = refine_image
        self.beam_size = int(beam_size)
        self.max_gen_len = int(max_gen_len)
        self.length_penalty = float(length_penalty)
        self.lang2id = dict(lang2id or {})
        self.store = None   # a RegionFeatureStore for image_id payloads
        self._gallery: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self.q8_bytes = 0
        if "int8_infer" in (model.cfg.ffn_quant, model.cfg.head_quant):
            self.q8_bytes = capture_q8(self.model)
            logger.info("serve: frozen-weight int8 tables captured (%d "
                        "bytes)", self.q8_bytes)

    @classmethod
    def from_checkpoint(cls, path: str, model_cfg, tokenizer=None, *,
                        quant: str = "none",
                        device: Union[str, torch.device] = "cuda",
                        **kw) -> "InferenceEngine":
        """Build the model on ``device`` and load a reference ``.pth`` or a
        ``.pt`` saved by the port (`checkpoint.load_weights`); keys a
        ``.pth`` lacks keep the seed-0 initial values.  ``quant="int8"``
        serves the same checkpoint through the frozen-weight int8 path
        (the model in ``int8_infer`` mode, its tables captured at
        construction)."""
        from m3p_tpu_torch.checkpoint import load_weights
        from m3p_tpu_torch.model import build_model

        if quant == "int8":
            model_cfg = dataclasses.replace(
                model_cfg, ffn_quant="int8_infer", head_quant="int8_infer")
        elif quant != "none":
            raise ValueError(f"unknown quant mode {quant!r}; known: "
                             f"'none', 'int8'")
        model = build_model(model_cfg, 0, device)
        load_weights(model, path)
        return cls(model, tokenizer, device=device,
                   max_regions=model_cfg.max_region_num, **kw)

    def attach_store(self, path: str) -> None:
        """Serve image payloads by ``image_id`` out of a reference-layout h5
        shard (`data/features.py`)."""
        from m3p_tpu_torch.data.features import RegionFeatureStore

        self.store = RegionFeatureStore(path, self.max_regions)

    # -- payload handling ----------------------------------------------------

    def resolve_image(self, obj: Dict[str, Any]
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (feats (R, 2048) L2-normalized, locs (R, 5), num_boxes) from
        {"image_id": ...} (an attached store), inline {"feats", "locs"} or
        {"features", "boxes", "wh": [h, w]}."""
        if "image_id" in obj:
            if self.store is None:
                raise ValueError("image_id payloads need an attached feature "
                                 "store (attach_store)")
            try:
                index = self.store.index_of(obj["image_id"])
            except KeyError:
                raise ValueError(f"unknown image_id {obj['image_id']!r}"
                                 ) from None
            got = self.store.get(index)
            return got["feats"], got["locs"], int(got["num_boxes"])
        raw = obj.get("feats", obj.get("features"))
        if raw is None:
            raise ValueError("image payload needs image_id or a "
                             "feats/features array")
        feats = np.asarray(raw, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.feat_dim:
            raise ValueError(f"feats must be 2-d (r, {self.feat_dim}), "
                             f"got shape {feats.shape}")
        if "locs" in obj:
            locs = np.asarray(obj["locs"], np.float32)
        elif "boxes" in obj and "wh" in obj:
            h, w = np.asarray(obj["wh"], np.float32)
            locs = norm_boxes(np.asarray(obj["boxes"], np.float32), h, w)
        else:
            raise ValueError("image payload needs locs or boxes+wh")
        if locs.ndim != 2 or locs.shape[1] != 5:
            raise ValueError(f"locs must be 2-d (r, 5), got {locs.shape}")
        r = self.max_regions
        n = min(feats.shape[0], r)
        out_f = np.zeros((r, self.feat_dim), np.float32)
        out_l = np.zeros((r, 5), np.float32)
        out_f[:n] = l2_normalize(feats[:n])
        out_l[:n] = locs[:n]
        return out_f, out_l, n

    def _tokenize_bucketed(self, texts: Sequence[str]
                           ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Encode, pick the smallest text bucket that fits, pad to it;
        -> (tokens, lengths, bucket_len)."""
        if self.tokenizer is None:
            raise ValueError("this engine has no tokenizer (pass one to the "
                             "constructor for text endpoints)")
        ids = self.tokenizer.encode_batch(
            list(texts), max_ids=max(self.text_buckets) - 2)
        sl = _bucket(max((len(s) + 2 for s in ids), default=2),
                     self.text_buckets)
        toks, lens, _ = batch_sentences(ids, max_len=sl)
        return toks, lens, sl

    def lang_id(self, lang: Optional[str]) -> Optional[int]:
        if lang is None:
            return None
        if lang not in self.lang2id:
            raise ValueError(f"unknown language {lang!r}; "
                             f"known: {sorted(self.lang2id)}")
        return self.lang2id[lang]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _forward(self, tokens: torch.Tensor, text_len: torch.Tensor,
                 feats: torch.Tensor, locs: torch.Tensor,
                 img_len: torch.Tensor) -> torch.Tensor:
        """ITM scores (B,) fp32 of one padded batch, on the device."""
        text_mask = lengths_to_mask(text_len, tokens.shape[1])
        img_mask = lengths_to_mask(img_len, feats.shape[1])
        hidden = self.model.encode_joint(tokens, text_mask, feats, locs,
                                         img_mask, self.refine_image)
        return self.model.itm_score(hidden)[:, 0].float()

    # -- public entry points ---------------------------------------------

    def score(self, texts: Sequence[str],
              images: Sequence[Dict[str, Any]]) -> List[float]:
        """ITM relevance score per (text, image) pair."""
        if len(texts) != len(images):
            raise ValueError(f"{len(texts)} texts for {len(images)} images")
        out: List[float] = []
        cap = self.batch_buckets[-1]
        for start in range(0, len(texts), cap):
            t = texts[start:start + cap]
            im = images[start:start + cap]
            sb = _bucket(len(t), self.batch_buckets)
            resolved = [self.resolve_image(o) for o in im]
            tokens, lengths, sl = self._tokenize_bucketed(t)
            feats = np.zeros((sb, self.max_regions, self.feat_dim),
                             np.float32)
            locs = np.zeros((sb, self.max_regions, 5), np.float32)
            img_len = np.zeros((sb,), np.int64)
            toks = np.full((sb, sl), PAD_IDX, np.int64)
            tl = np.full((sb,), 2, np.int64)
            toks[: len(t)] = tokens
            tl[: len(t)] = lengths
            for i, (f, l, n) in enumerate(resolved):
                feats[i], locs[i], img_len[i] = f, l, n
            with self._lock, torch.inference_mode():
                s = self._forward(self._to_device(toks), self._to_device(tl),
                                  self._to_device(feats),
                                  self._to_device(locs),
                                  self._to_device(img_len))
                out.extend(s[: len(t)].cpu().tolist())
        return out

    def load_gallery(self, images: Sequence[Dict[str, Any]],
                     ids: Optional[Sequence[str]] = None) -> int:
        """Stage a retrieval gallery on the device; returns its size."""
        resolved = [self.resolve_image(o) for o in images]
        if not resolved:
            raise ValueError("empty gallery")
        if ids is not None and len(ids) != len(resolved):
            raise ValueError(f"{len(ids)} ids for {len(resolved)} images")
        gallery = {
            "feats": self._to_device(np.stack([f for f, _, _ in resolved])),
            "locs": self._to_device(np.stack([l for _, l, _ in resolved])),
            "len": self._to_device(
                np.array([n for _, _, n in resolved], np.int64)),
            "ids": (list(ids) if ids is not None
                    else [str(i) for i in range(len(resolved))]),
        }
        with self._lock:
            self._gallery = gallery
        return len(resolved)

    def load_gallery_from_store(self, limit: Optional[int] = None) -> int:
        """Stage the attached store's first ``limit`` images (all without a
        limit) as the gallery, keyed by their image ids."""
        if self.store is None:
            raise ValueError("no feature store attached")
        n = len(self.store) if limit is None else min(limit, len(self.store))
        ids = [str(i) for i in self.store.image_ids[:n]]
        return self.load_gallery([{"image_id": i} for i in ids], ids)

    def retrieve(self, text: str, top_k: int = 10) -> List[Dict[str, Any]]:
        """Rank the loaded gallery for one query; -> [{id, score}] best-first.

        Every (query, image) pair goes through the same joint forward as
        `score`, in chunks of the largest batch bucket (the last chunk padded
        with image 0); the gallery never leaves the device."""
        tokens, lengths, _ = self._tokenize_bucketed([text])
        with self._lock, torch.inference_mode():
            g = self._gallery
            if g is None:
                raise ValueError("no gallery loaded (load_gallery)")
            n = int(g["feats"].shape[0])
            chunk = self.batch_buckets[-1]
            toks = self._to_device(tokens.astype(np.int64)).expand(chunk, -1)
            tl = self._to_device(lengths.astype(np.int64)).expand(chunk)
            scores = torch.empty((n,), dtype=torch.float32,
                                 device=self.device)
            for start in range(0, n, chunk):
                size = min(chunk, n - start)
                idx = torch.zeros((chunk,), dtype=torch.long,
                                  device=self.device)
                idx[:size] = torch.arange(start, start + size,
                                          device=self.device)
                s = self._forward(toks, tl,
                                  g["feats"].index_select(0, idx),
                                  g["locs"].index_select(0, idx),
                                  g["len"].index_select(0, idx))
                scores[start:start + size] = s[:size]
            host = scores.cpu().numpy()
            ids = g["ids"]
        order = np.argsort(-host, kind="stable")[:top_k]
        return [{"id": ids[i], "score": float(host[i])} for i in order]

    def _generate(self, src_enc: torch.Tensor, src_mask: torch.Tensor,
                  beam_size: int, max_len: int, lang_id: Optional[int]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, lengths) on the host: beam search above beam 1, greedy
        at 1 (`m3p_tpu/serve/engine.py:226-277`)."""
        if beam_size > 1:
            toks, lens = beam_search(self.model, src_enc, src_mask,
                                     beam_size, max_len, tgt_lang_id=lang_id,
                                     length_penalty=self.length_penalty)
        else:
            toks, lens = greedy_generate(self.model, src_enc, src_mask,
                                         max_len, tgt_lang_id=lang_id)
        return toks.cpu().numpy(), lens.cpu().numpy()

    def _decode(self, toks: np.ndarray, lens: np.ndarray, n: int
                ) -> List[str]:
        """The first ``n`` rows as text, the start token and the EOS cut."""
        return [self.tokenizer.decode(toks[i, 1:lens[i]]) for i in range(n)]

    def _generation_args(self, beam_size, max_len):
        if self.tokenizer is None:
            raise ValueError("this engine has no tokenizer (pass one to the "
                             "constructor for text endpoints)")
        beam_size = self.beam_size if beam_size is None else int(beam_size)
        max_len = self.max_gen_len if max_len is None else int(max_len)
        # decode step t reads position t < max_positions, and the last step
        # is t = max_len - 2: a longer request would index past the table
        # (on CUDA a device-side assert that breaks every later request)
        limit = self.model.cfg.max_positions + 1
        if not 1 <= max_len <= limit:
            raise ValueError(f"max_len {max_len} must lie in [1, {limit}]")
        if beam_size < 1:
            raise ValueError(f"beam_size {beam_size} must be at least 1")
        return beam_size, max_len

    def image_batch(self, images: Sequence[Dict[str, Any]]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(feats, locs, mask) of at most the largest batch bucket of
        images, on the device, padded to their bucket: a padding row keeps
        one region (`m3p_tpu/serve/engine.py:415-422`)."""
        sb = _bucket(len(images), self.batch_buckets)
        feats = np.zeros((sb, self.max_regions, self.feat_dim), np.float32)
        locs = np.zeros((sb, self.max_regions, 5), np.float32)
        img_len = np.ones((sb,), np.int64)
        for i, o in enumerate(images):
            f, l, n = self.resolve_image(o)
            feats[i], locs[i], img_len[i] = f, l, max(n, 1)
        return (self._to_device(feats), self._to_device(locs),
                lengths_to_mask(self._to_device(img_len), self.max_regions))

    def caption(self, images: Sequence[Dict[str, Any]],
                lang: Optional[str] = None,
                beam_size: Optional[int] = None,
                max_len: Optional[int] = None) -> List[str]:
        """A caption per image (beam search by default): the images padded
        to a batch bucket (a padding row keeps one region), encoded by
        `encode_image`, decoded (`m3p_tpu/serve/engine.py:399-431`)."""
        if not images:
            return []
        beam_size, max_len = self._generation_args(beam_size, max_len)
        lang_id = self.lang_id(lang)
        out: List[str] = []
        cap = self.batch_buckets[-1]
        for start in range(0, len(images), cap):
            im = images[start:start + cap]
            feats, locs, img_mask = self.image_batch(im)
            with self._lock, torch.inference_mode():
                src_enc = self.model.encode_image(feats, locs, img_mask,
                                                  self.refine_image)
                toks, lens = self._generate(src_enc, img_mask, beam_size,
                                            max_len, lang_id)
            out.extend(self._decode(toks, lens, len(im)))
        return out

    def translate(self, texts: Sequence[str], tgt_lang: Optional[str],
                  src_lang: Optional[str] = None,
                  beam_size: Optional[int] = None,
                  max_len: Optional[int] = None) -> List[str]:
        """Sequence-to-sequence generation against the text encoder, the
        source's language embedding when ``src_lang`` is given
        (`m3p_tpu/serve/engine.py:433-468`)."""
        if not texts:
            return []
        beam_size, max_len = self._generation_args(beam_size, max_len)
        tgt_id = self.lang_id(tgt_lang)
        src_id = self.lang_id(src_lang)
        out: List[str] = []
        cap = self.batch_buckets[-1]
        for start in range(0, len(texts), cap):
            t = texts[start:start + cap]
            sb = _bucket(len(t), self.batch_buckets)
            tokens, lengths, sl = self._tokenize_bucketed(t)
            toks = np.full((sb, sl), PAD_IDX, np.int64)
            tl = np.full((sb,), 2, np.int64)
            toks[: len(t)] = tokens
            tl[: len(t)] = lengths
            langs = None
            if src_id is not None:
                langs = np.zeros((sb, sl), np.int64)
                langs[: len(t)] = src_id
            with self._lock, torch.inference_mode():
                src_mask = lengths_to_mask(self._to_device(tl), sl)
                src_enc = self.model.encode_text(
                    self._to_device(toks), src_mask,
                    None if langs is None else self._to_device(langs))
                otoks, olens = self._generate(src_enc, src_mask, beam_size,
                                              max_len, tgt_id)
            out.extend(self._decode(otoks, olens, len(t)))
        return out

    # -- ops ------------------------------------------------------------

    def warmup(self, batch: Optional[int] = None,
               text_len: Optional[int] = None) -> None:
        """One scoring pass at the default bucket, so the first request
        does not pay for the kernel build and the first launches."""
        sb = batch or self.batch_buckets[-1]
        sl = text_len or self.text_buckets[0]
        dev = self.device
        with self._lock, torch.inference_mode():
            s = self._forward(
                torch.full((sb, sl), PAD_IDX, dtype=torch.long, device=dev),
                torch.full((sb,), 2, dtype=torch.long, device=dev),
                torch.zeros((sb, self.max_regions, self.feat_dim),
                            device=dev),
                torch.zeros((sb, self.max_regions, 5), device=dev),
                torch.ones((sb,), dtype=torch.long, device=dev))
            s.cpu()

    def stats(self) -> Dict[str, Any]:
        g = self._gallery
        return {
            "devices": [str(self.device)],
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "gallery_size": int(g["feats"].shape[0]) if g else 0,
            "languages": sorted(self.lang2id),
            "endpoints": ["score", "retrieve", "caption", "translate"],
            "generation": {"beam_size": self.beam_size,
                           "max_gen_len": self.max_gen_len,
                           "length_penalty": self.length_penalty},
        }
