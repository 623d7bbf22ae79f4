"""Full-grid image-text retrieval evaluation of the port (counterpart of
`m3p_tpu/eval/retrieval.py`).

Every (caption, image) pair of a test grid is scored by the ITM head on
the [img; caption] joint encoding, in fixed-size chunks of pairs; the
(n_images, n_captions) fp32 score matrix assembles on the host and R@k
reduces with numpy.  Ranking directions and R@1/5/10 + mean recall follow
the reference's `evaluate_image_retrieval` (`xevaluator.py:1621-1657`).

The caption pool and the unique images are put on the model's device
once; a chunk gathers its pairs there with ``index_select`` from two int64
index vectors (image, caption), so the 100 x 2048 region features are
never replicated per pair on the host.  The index vectors of every chunk
go to the device in one copy before the first chunk.  Every chunk is
launched before the host waits for any: each one's scores are copied into
pinned host memory on the device's stream and marked by a CUDA event, so
the host reads a chunk as soon as it is done, and the progress log tracks
real completion.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch

from m3p_tpu_torch.model.transformer import M3PModel, lengths_to_mask

logger = logging.getLogger(__name__)


def _score_chunk(model: M3PModel, cap_tokens: torch.Tensor,
                 cap_len: torch.Tensor, img_feats: torch.Tensor,
                 img_locs: torch.Tensor, img_len: torch.Tensor,
                 cap_idx: torch.Tensor, img_idx: torch.Tensor,
                 refine_image: bool, text_width: int) -> torch.Tensor:
    """fp32 ITM scores (chunk,) of the pairs (img_idx[i], cap_idx[i]), the
    captions cut to their bucket's ``text_width`` tokens."""
    tokens = cap_tokens.index_select(0, cap_idx)[:, :text_width]
    text_len = cap_len.index_select(0, cap_idx)
    feats = img_feats.index_select(0, img_idx)
    locs = img_locs.index_select(0, img_idx)
    ilen = img_len.index_select(0, img_idx)
    text_mask = lengths_to_mask(text_len, tokens.shape[1])
    img_mask = lengths_to_mask(ilen, feats.shape[1])
    hidden = model.encode_joint(tokens, text_mask, feats, locs, img_mask,
                                refine_image)
    return model.itm_score(hidden)[:, 0].float()


def _tasks(cap_len: np.ndarray, n_img: int, width: int, chunk_size: int,
           length_bucket: bool, min_bucket: int):
    """The flat task list, identical on every process: (width, bucket
    caption ids, pair-range start) per chunk (`m3p_tpu/eval/retrieval.py:
    109-127`)."""
    widths = [width]
    if length_bucket:
        while widths[-1] % 2 == 0 and widths[-1] // 2 >= max(min_bucket, 2):
            widths.append(widths[-1] // 2)
    cap_w = np.full((cap_len.shape[0],), width, np.int64)
    for w in widths[1:]:
        cap_w[np.asarray(cap_len) <= w] = w
    tasks = []
    for w in widths:
        sel = np.where(cap_w == w)[0]
        if sel.size == 0:
            continue
        for start in range(0, n_img * sel.size, chunk_size):
            tasks.append((w, sel, start))
    return tasks


@torch.inference_mode()
def retrieval_grid_scores(
    model: M3PModel,
    cap_tokens: np.ndarray,     # (n_cap, S)
    cap_len: np.ndarray,        # (n_cap,)
    img_feats: np.ndarray,      # (n_img, R, 2048)
    img_locs: np.ndarray,       # (n_img, R, 5)
    img_len: np.ndarray,        # (n_img,)
    chunk_size: int = 512,
    refine_image: bool = True,
    batch_sharding=None,
    process_index: int = 0,
    process_count: int = 1,
    length_bucket: bool = False,
    min_bucket: int = 16,
) -> np.ndarray:
    """Score all n_img x n_cap pairs on the model's device; returns the
    fp32 (n_img, n_cap) score matrix.

    With ``process_count > 1`` this process scores every
    ``process_count``-th chunk from ``process_index`` and unscored entries
    stay 0; the partial matrices sum to the whole.  The last chunk of a
    bucket is padded with image 0 and the bucket's first caption, and the
    padded rows are dropped.

    ``length_bucket`` groups captions into power-of-two length buckets (S,
    S/2, ... down to ``min_bucket``) and scores each bucket's pairs with
    the token pool cut to its width, so short captions do not pay for the
    padded joint sequence.  Padding is masked, so the scores agree with
    the unbucketed ones up to summation order.  Off by default.

    ``batch_sharding`` (`parallel.sharding.batch_sharding`): a port
    process drives one card, so the chunks, not a chunk's rows, are shared
    out over the mesh's batch shards: it stands for ``process_index`` /
    ``process_count`` = its (index, count), and the partial matrices of the
    shards sum to the whole."""
    if batch_sharding is not None:
        process_index, process_count = (batch_sharding.index,
                                        batch_sharding.count)
    n_cap, width = cap_tokens.shape
    n_img = img_feats.shape[0]
    dev = next(model.parameters()).device

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    # the caption pool and the unique images on the device, once
    cap_tokens_d = put(cap_tokens, np.int64)
    cap_len_d = put(cap_len, np.int64)
    img_feats_d = put(img_feats, np.float32)
    img_locs_d = put(img_locs, np.float32)
    img_len_d = put(img_len, np.int64)

    tasks = _tasks(np.asarray(cap_len), n_img, width, chunk_size,
                   length_bucket, min_bucket)
    my_tasks = tasks[process_index::process_count]
    # per chunk: the real pairs' (image, caption) ids on the host, and the
    # padded index vectors for the device
    real, index = [], np.zeros((len(my_tasks), 2, chunk_size), np.int64)
    for t, (w, sel, start) in enumerate(my_tasks):
        idx = np.arange(start, min(start + chunk_size, n_img * sel.size))
        pad = chunk_size - idx.size
        ii = np.concatenate([idx // sel.size, np.zeros(pad, np.int64)])
        ci = sel[np.concatenate([idx % sel.size, np.zeros(pad, np.int64)])]
        index[t, 0], index[t, 1] = ii, ci
        real.append((ii[: idx.size], ci[: idx.size]))
    index_d = torch.from_numpy(index).to(dev)

    on_cuda = dev.type == "cuda"
    host = torch.empty((len(my_tasks), chunk_size), dtype=torch.float32,
                       pin_memory=on_cuda)
    events = []
    # dispatch every chunk before the host waits for any: a sync per chunk
    # would stall the device between chunks
    for t, (w, _, _) in enumerate(my_tasks):
        s = _score_chunk(model, cap_tokens_d, cap_len_d, img_feats_d,
                         img_locs_d, img_len_d, index_d[t, 1], index_d[t, 0],
                         refine_image, w)
        host[t].copy_(s, non_blocking=on_cuda)
        if on_cuda:
            done = torch.cuda.Event()
            done.record()
            events.append(done)

    # the host copy: each chunk as soon as its event has passed, so the
    # progress log (time-throttled: chatty on big grids, silent on the
    # per-epoch monitoring evals) tracks real completion
    out = np.zeros((n_img, n_cap), np.float32)
    scores = host.numpy()
    t0 = time.perf_counter()
    last_log = t0
    pairs_done = 0
    for k, (ii, ci) in enumerate(real):
        if on_cuda:
            events[k].synchronize()
        out[ii, ci] = scores[k, : ii.size]
        pairs_done += ii.size
        now = time.perf_counter()
        if now - last_log >= 60.0:
            rate = pairs_done / max(now - t0, 1e-9)
            left = sum(p[0].size for p in real[k + 1:])
            logger.info(
                "grid eval: %d/%d chunks, %d pairs scored, %.0f pairs/s, "
                "eta %.1f min", k + 1, len(real), pairs_done, rate,
                left / max(rate, 1e-9) / 60.0)
            last_log = now
    return out


def merge_process_scores(scores: np.ndarray, group=None) -> np.ndarray:
    """Merge per-process partial score matrices (unscored entries 0) by
    summing them over every rank of the process group, or of ``group``
    (`m3p_tpu/eval/retrieval.py:168-178`, the reference's per-rank dumps
    merged in process); the identity in one process.  Over NCCL the sum
    runs on this rank's card."""
    dist = torch.distributed
    on = {} if group is None else {"group": group}
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size(**on) > 1):
        return scores
    t = torch.tensor(scores, dtype=torch.float32)    # a copy
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, **on)
    return t.cpu().numpy()


def recall_at_k(
    scores: np.ndarray,          # (n_img, n_cap)
    cap_to_img: np.ndarray,      # (n_cap,) ground-truth image per caption
    ks=(1, 5, 10),
) -> Dict[str, float]:
    """R@k both directions + mean recall (`xevaluator.py:1621-1657`); a
    copy of `m3p_tpu/eval/retrieval.py:181-214`, the same ``argsort``, so
    ties rank as there.

    i2t: for each image, rank captions; hit if any gold caption in top-k.
    t2i: for each caption, rank images; hit if the gold image in top-k.
    """
    n_img, n_cap = scores.shape
    out: Dict[str, float] = {}

    order_i2t = np.argsort(-scores, axis=1)          # (n_img, n_cap)
    gold_per_img = [np.where(cap_to_img == i)[0] for i in range(n_img)]
    for k in ks:
        hits = 0
        for i in range(n_img):
            topk = order_i2t[i, :k]
            hits += bool(np.isin(topk, gold_per_img[i]).any())
        out[f"i2t_r{k}"] = 100.0 * hits / n_img

    order_t2i = np.argsort(-scores, axis=0)          # (n_img, n_cap) cols
    for k in ks:
        hits = 0
        for c in range(n_cap):
            topk = order_t2i[:k, c]
            hits += bool((topk == cap_to_img[c]).any())
        out[f"t2i_r{k}"] = 100.0 * hits / n_cap

    out["mean_recall"] = float(np.mean(
        [out[f"{d}_r{k}"] for d in ("i2t", "t2i") for k in ks]))
    return out
