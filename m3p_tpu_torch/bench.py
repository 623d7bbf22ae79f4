"""MCT pre-training throughput of the port on one GPU (the counterpart of
the repo's ``bench.py``).

    python -m m3p_tpu_torch.bench [--fused_dropout] [--ffn_quant MODE]
        [--seed 0]

Runs the full multitask pre-training step -- 12 blocks, 768d, 12 heads,
250002 words, the joint [100 regions; 64 tokens] encoder with the 3-layer
AoA refiner, ITM + MC-MLM + MC-MRM + MRFR, on-device word and region
masking, dropout and attention dropout 0.1, bf16 compute, the FFNs through
the int8 GEMMs with int8 backward passes (``ffn_quant="int8_bwd"``) -- on a
synthetic
batch of 20 groups x 4 candidates (BN = 80 joint sequences of 164 tokens,
`make_pretrain_batch`), with ``MaskingConfig(max_pred=16)``, all lambdas
1.0, the MLM slots packed at ``pack_ratio=0.25``, and bench.py's optimizer:
``adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005,fused=1,
mu_dtype=bfloat16,nu_dtype=bfloat16,master=1`` with clip 5.0.  3 warm-up
and 20 timed steps, timed with CUDA events.  ``--fused_dropout`` sets
``use_fused_dropout``: every residual dropout of the encoder through the
fused kernels.  This is bench.py's configuration with no cut;
``--ffn_quant none`` runs the FFNs' float GEMMs for a comparison.

FLOPs: `mct_step_flops` counts 3 x the forward's matrix products from the
shapes (the backward is twice the forward): per joint sequence of S
tokens, each block's Q/K/V/out and FFN GEMMs, 2 (4 d^2 + 2 d f) S, and
its two attention products, 4 S^2 d; the region projection, 2 R (2048 +
5) d; each AoA refiner layer's Q/K/V, gate and FFN GEMMs, 2 (7 d^2 +
2 d f) R, and attention, 4 R^2 d; the tied word head over the packed MLM
slots, 2 slots d V; the object head (2 (d^2 + 1600 d)) and MRFR head
(2 (2048 d)) over the packed region slots; the ITM pooler; and with CLCM a
second joint encode.  Embedding gathers, LayerNorm, softmax, GELU and the
optimizer are left out.  MFU is against 989 TFLOP/s, the H100 SXM dense
bf16 peak.  The count and the peak are the same under ``int8_bwd``: its
integer GEMMs do the same products, so its MFU compares with the float
step's.  The JSON line has no baseline ratio: no TPU or V100 figure is a
baseline for the port.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data.masking import MaskingConfig
from m3p_tpu_torch.data.synthetic import make_pretrain_batch
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.train.optim import build_optimizer
from m3p_tpu_torch.train.state import TrainState, create_train_state
from m3p_tpu_torch.train.steps import make_train_step, mct_pretrain_loss

GROUPS, SAMPLE_N, MAX_LEN, MAX_REGIONS = 20, 4, 64, 100
WARMUP, STEPS = 3, 20
MAX_PRED = 16
PACK_RATIO = 0.25
OPTIM_SPEC = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005,fused=1,"
              "mu_dtype=bfloat16,nu_dtype=bfloat16,master=1")
CLIP = 5.0
BF16_PEAK_FLOPS = 989e12
FFN_QUANT = "int8_bwd"


def bench_config(fused_dropout: bool = False, n_layers: int = 12,
                 dtype: str = "bfloat16", rate: float = 0.1,
                 ffn_quant: str = FFN_QUANT) -> ModelConfig:
    """bench.py's ModelConfig (`bench.py:56`, `:88`)."""
    return ModelConfig(n_words=250002, mask_index=250001, n_layers=n_layers,
                       emb_dim=768, n_heads=12, dropout=rate,
                       attention_dropout=rate, max_region_num=MAX_REGIONS,
                       dtype=dtype, use_fused_dropout=fused_dropout,
                       ffn_quant=ffn_quant)


def mask_config(cfg: ModelConfig) -> MaskingConfig:
    return MaskingConfig(max_pred=MAX_PRED, n_words=cfg.n_words,
                         mask_index=cfg.mask_index)


def make_batch(seed: int, device: Union[str, torch.device],
               groups: int = GROUPS, with_clcm: bool = False,
               clcm_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """`make_pretrain_batch` from ``RandomState(seed)``, on ``device``."""
    batch = make_pretrain_batch(np.random.RandomState(seed), groups,
                                SAMPLE_N, MAX_LEN, MAX_REGIONS, 250002,
                                with_clcm=with_clcm, clcm_len=clcm_len)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_step(cfg: ModelConfig, **kw):
    """The train step over `mct_pretrain_loss` with bench.py's arguments;
    ``kw`` adds or overrides loss arguments (a fixed coin or masking)."""
    loss_kw = dict(mask_cfg=mask_config(cfg), sample_n=SAMPLE_N,
                   lambda_rel=1.0, lambda_mlm=1.0, lambda_mrm=1.0,
                   lambda_mrfr=1.0, lambda_clcm=1.0, refine_image=True,
                   deterministic=False, pack_ratio=PACK_RATIO)
    loss_kw.update(kw)
    return make_train_step(functools.partial(mct_pretrain_loss, **loss_kw))


def setup(cfg: ModelConfig, seed: int = 0,
          device: Union[str, torch.device] = "cuda",
          spec: str = OPTIM_SPEC):
    """(state, step, generators): the model with random weights from
    ``seed``, the fused optimizer state, the step, and the generators of
    the masks and seeds."""
    model = build_model(cfg, seed, device)
    tx, _ = build_optimizer(spec, clip_grad_norm=CLIP)
    state = create_train_state(model, tx)
    return state, make_step(cfg), Generators.from_seed(seed, device)


def packed_slots(bn: int, pack_ratio: float = PACK_RATIO) -> Dict[str, int]:
    """The MLM and region slots the loss packs (its ``top_k`` budgets)."""
    p = min(MAX_PRED, MAX_LEN)
    return {"text": max(int(bn * p * pack_ratio), 1),
            "regions": max((bn * min(MAX_PRED, MAX_REGIONS)) // 2, 1)}


def joint_forward_flops(cfg: ModelConfig, s: int,
                        regions: int = MAX_REGIONS) -> int:
    """Forward FLOPs of one joint sequence of ``s`` tokens over ``regions``
    regions with the ITM pooler (the module docstring's count): the
    region projection, the refiner, the blocks and the pooler."""
    d, f = cfg.emb_dim, cfg.ffn_dim
    image = 2 * regions * (cfg.img_feat_dim + cfg.img_loc_dim) * d
    refiner = cfg.refine_layers * (2 * (7 * d * d + 2 * d * f) * regions
                                   + 4 * regions * regions * d)
    blocks = cfg.n_layers * (2 * (4 * d * d + 2 * d * f) * s + 4 * s * s * d)
    pooler = 2 * (d * d + d)
    return image + refiner + blocks + pooler


def mct_step_flops(cfg: ModelConfig, bn: int, text_len: int = MAX_LEN,
                   regions: int = MAX_REGIONS,
                   clcm_len: Optional[int] = None,
                   pack_ratio: float = PACK_RATIO) -> int:
    """Model FLOPs of one training step (the module docstring's count),
    the MLM slots packed at ``pack_ratio``."""
    d = cfg.emb_dim
    slots = packed_slots(bn, pack_ratio)

    def encode(s):
        return bn * joint_forward_flops(cfg, s, regions)

    forward = encode(regions + text_len)
    forward += 2 * slots["text"] * d * cfg.n_words
    forward += 2 * slots["regions"] * (d * d + d * cfg.n_obj_classes
                                       + d * cfg.img_feat_dim)
    if clcm_len:
        forward += encode(regions + clcm_len)
    return 3 * forward


def run(state: TrainState, step, batch: Dict[str, torch.Tensor],
        gens: Generators, warmup: int = WARMUP, steps: int = STEPS) -> dict:
    """``warmup`` then ``steps`` timed steps on the GPU: step ms (CUDA
    events), samples/s, host wall ms a step, peak memory, the losses."""
    bn = batch["tokens"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            wall0 = time.perf_counter()
            start.record()
        state, m = step(state, batch, gens)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall0
    step_ms = start.elapsed_time(end) / steps
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    return {"step_ms": step_ms, "samples_per_s": bn / (step_ms / 1e3),
            "wall_step_ms": wall_s * 1e3 / steps,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "bn": bn, "steps": steps, "warmup": warmup,
            "losses": losses.tolist()}


def card() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fused_dropout", action="store_true",
                   help="use_fused_dropout: residual dropout through the "
                        "fused kernels")
    p.add_argument("--ffn_quant", default=FFN_QUANT,
                   choices=("int8_bwd", "none"),
                   help="the FFNs' GEMMs: bench.py's int8 (default) or "
                        "float, for a comparison")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bench_config(fused_dropout=args.fused_dropout,
                       ffn_quant=args.ffn_quant)
    state, step, gens = setup(cfg, args.seed, "cuda")
    batch = make_batch(0, "cuda")
    out = run(state, step, batch, gens)
    if not np.isfinite(out["losses"]).all():
        raise SystemExit(f"non-finite loss: {out['losses']}")
    flops = mct_step_flops(cfg, out["bn"])
    tflops = flops / (out["step_ms"] / 1e3) / 1e12
    print(json.dumps({
        "metric": "pretrain_samples_per_sec",
        "value": out["samples_per_s"],
        "unit": "samples/s",
        "step_ms": out["step_ms"],
        "peak_memory_gb": out["peak_memory_gb"],
        "flops_per_sample": flops / out["bn"],
        "tflops_per_sec": tflops,
        "mfu_vs_bf16_peak": tflops * 1e12 / BF16_PEAK_FLOPS,
        "device": torch.cuda.get_device_name(0),
        "card": card(),
        "config": {"attention_dropout": cfg.attention_dropout,
                   "dropout": cfg.dropout, "batch": out["bn"],
                   "layers": cfg.n_layers, "dim": cfg.emb_dim,
                   "joint_seq": MAX_LEN + MAX_REGIONS,
                   "use_fused_dropout": cfg.use_fused_dropout,
                   "ffn_quant": cfg.ffn_quant,
                   "optimizer": OPTIM_SPEC, "pack_ratio": PACK_RATIO,
                   "warmup": out["warmup"], "steps": out["steps"]},
    }))


if __name__ == "__main__":
    main()
