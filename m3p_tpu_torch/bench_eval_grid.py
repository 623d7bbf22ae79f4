"""Retrieval eval-grid throughput of the port on one GPU (counterpart of
`tools/bench_eval_grid.py`): pairs/s of the chunked joint-forward scorer
`m3p_tpu_torch.eval.retrieval.retrieval_grid_scores`.

    python -m m3p_tpu_torch.bench_eval_grid [n_img n_cap chunk] [--bucket]
        [--once] [--caplen LO:HI] [--int8] [--q8] [--seed 0]

The flagship model (12 blocks, 768d, 12 heads, 3 AoA refiner layers,
250002 words, bf16, random weights from ``--seed`` through `build_model`)
scores a synthetic caption/image pool shaped like Multi30K test, built
from ``RandomState(0)`` as the tool builds it: ``n_img`` images of 100
regions and ``n_cap`` captions of 64-token width whose lengths are drawn
from ``--caplen`` (default 8:20).  Defaults: 100 x 500, chunk 512.

``--bucket`` turns on caption length bucketing; ``--once`` times one pass
(the first, kernels loading included) instead of one untimed pass and one
timed pass over the same pool.  It prints one JSON line: pairs, chunk,
bucket, caplen, secs, pairs_per_s, the #1 launches of the timed pass, the
model FLOPs (`bench.joint_forward_flops` of each pair at its chunk's joint
width) and the MFU against 989 TFLOP/s, and the card's name and power limit.

``--q8`` scores through the frozen-weight int8 model
(`model.quantized_inference_model`, its tables captured once; the line
adds ``q8_capture_secs``).  At the tool's chunks every block GEMM has more
than `ops.quant.PREQUANT_MAX_M` rows and takes the plain GEMM, as in JAX.

``--int8`` builds the model with ``ffn_quant="int8_bwd"``: every FFN
GEMM through the dynamic int8 GEMM (`ops.quant.int8_matmul_qbwd`), as the
JAX tool's flag does.  With ``--q8`` as well, ``--q8`` wins: the int8
inference model replaces ``ffn_quant``, as in JAX.

It runs on the card and exits non-zero without one.  ``--device cpu``,
``--n_layers`` and ``--n_words`` exist for the tests (a cut model on the
CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from m3p_tpu_torch.bench import BF16_PEAK_FLOPS, card, joint_forward_flops
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.eval.retrieval import _tasks, retrieval_grid_scores
from m3p_tpu_torch.model import (
    build_model, capture_q8, quantized_inference_model)
from m3p_tpu_torch.ops.attention import attention_packed

TEXT_WIDTH, REGIONS = 64, 100


def grid_config(n_layers: int = 12, n_words: int = 250002,
                ffn_quant: str = "none") -> ModelConfig:
    """The tool's model: the flagship width in bf16 (dropout 0.1 and
    attention dropout 0 as the JAX tool sets them; evaluation runs
    deterministic)."""
    return ModelConfig(n_words=n_words, mask_index=n_words - 1,
                       n_layers=n_layers, emb_dim=768, n_heads=12,
                       ffn_quant=ffn_quant,
                       dropout=0.1, attention_dropout=0.0,
                       max_region_num=REGIONS, dtype="bfloat16")


def grid_pool(n_img: int, n_cap: int, lo: int = 8, hi: int = 20,
              n_words: int = 250002):
    """The tool's synthetic pool from ``RandomState(0)``, drawn in its
    order: (cap_tokens, cap_len, img_feats, img_locs, img_len)."""
    rng = np.random.RandomState(0)
    cap_tokens = np.ones((n_cap, TEXT_WIDTH), np.int32)  # pad = 1
    cap_len = rng.randint(lo, hi + 1, (n_cap,)).astype(np.int32)
    for i, n in enumerate(cap_len):
        cap_tokens[i, :n] = rng.randint(4, min(250000, n_words - 1), n)
    img_feats = rng.randn(n_img, REGIONS, 2048).astype(np.float32)
    img_locs = rng.rand(n_img, REGIONS, 5).astype(np.float32)
    img_len = np.full((n_img,), REGIONS, np.int32)
    return cap_tokens, cap_len, img_feats, img_locs, img_len


def grid_flops(cfg: ModelConfig, cap_len: np.ndarray, n_img: int,
               chunk: int, bucket: bool) -> int:
    """Model FLOPs of one pass: every pair at its chunk's joint width (the
    padded rows of a bucket's last chunk left out)."""
    tasks = _tasks(cap_len, n_img, TEXT_WIDTH, chunk, bucket, 16)
    return sum(min(chunk, n_img * sel.size - start)
               * joint_forward_flops(cfg, REGIONS + w, REGIONS)
               for w, sel, start in tasks)


def run(model, pool, chunk: int, bucket: bool, once: bool) -> dict:
    """One untimed and one timed pass (one timed pass with ``once``);
    -> the timed pass's numbers and its score matrix."""
    dev = next(model.parameters()).device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def one():
        return retrieval_grid_scores(model, *pool, chunk_size=chunk,
                                     length_bucket=bucket)

    out = {}
    if not once:
        t0 = time.perf_counter()
        one()
        out["first_pass_secs"] = time.perf_counter() - t0
    sync()
    attention_packed.launches = 0
    t0 = time.perf_counter()
    scores = one()
    sync()
    out["secs"] = time.perf_counter() - t0
    out["packed_fwd_launches"] = attention_packed.launches
    out["scores"] = scores
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="*", type=int,
                   help="n_img n_cap chunk (default 100 500 512)")
    p.add_argument("--bucket", action="store_true")
    p.add_argument("--once", action="store_true")
    p.add_argument("--caplen", default="8:20")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_layers", type=int, default=12)
    p.add_argument("--n_words", type=int, default=250002)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--q8", action="store_true")
    args = p.parse_args(argv)
    sizes = list(args.sizes) + [100, 500, 512][len(args.sizes):]
    n_img, n_cap, chunk = sizes[:3]
    lo, hi = (int(x) for x in args.caplen.split(":"))
    try:
        model = build_model(
            grid_config(args.n_layers, args.n_words,
                        "int8_bwd" if args.int8 else "none"),
            args.seed, args.device)
    except RuntimeError as exc:
        print(f"bench_eval_grid: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    q8_secs = None
    if args.q8:
        model = quantized_inference_model(model)
        t0 = time.perf_counter()
        capture_q8(model)
        if model.text_emb.word.weight.device.type == "cuda":
            torch.cuda.synchronize()
        q8_secs = time.perf_counter() - t0
    pool = grid_pool(n_img, n_cap, lo, hi, args.n_words)
    out = run(model, pool, chunk, args.bucket, args.once)
    scores = out.pop("scores")
    if scores.shape != (n_img, n_cap) or not np.isfinite(scores).all():
        print(f"bench_eval_grid: bad scores (shape {scores.shape}, "
              f"finite {bool(np.isfinite(scores).all())})", file=sys.stderr)
        return 1
    pairs = n_img * n_cap
    flops = grid_flops(model.cfg, pool[1], n_img, chunk, args.bucket)
    on_cuda = model.text_emb.word.weight.device.type == "cuda"
    print(json.dumps({
        "pairs": pairs, "chunk": chunk, "bucket": args.bucket,
        "q8": args.q8, "ffn_quant": model.cfg.ffn_quant, "q8_capture_secs": q8_secs,
        "caplen": f"{lo}:{hi}", "secs": out["secs"],
        "pairs_per_s": pairs / out["secs"],
        "first_pass_secs": out.get("first_pass_secs"),
        "packed_fwd_launches": out["packed_fwd_launches"],
        "flops": flops,
        "mfu_vs_bf16_peak": flops / out["secs"] / BF16_PEAK_FLOPS,
        "n_layers": args.n_layers, "n_words": args.n_words,
        "device": (torch.cuda.get_device_name(0) if on_cuda
                   else str(args.device)),
        "card": card() if on_cuda else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
