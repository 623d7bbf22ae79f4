"""Time the fused FFN + LayerNorm kernel on the card (counterpart of
`tools/bench_fused_ffn.py`).

    python -m m3p_tpu_torch.bench_fused_ffn [--m 13120 --d 768 --h 3072
                                             --iters 30]

At the tool's operating point (the MCT step's 80 x 164 = 13120 joint rows,
D = 768, H = 3072, bf16) and on the tool's inputs (numpy.random.RandomState
(0), drawn in its order: x ~ N(0, 1), W ~ 0.02 N(0, 1), zero biases, unit
gamma, zero beta), it times with CUDA events, after a warm-up:

* the kernel (`m3p_tpu_torch.ops.fused_ffn.fused_ffn_ln`, csrc/fused_ffn.cu);
* its plain version (`reference_ffn_ln`, fp32 products);
* the library yardstick ``F.layer_norm(x + F.linear(F.gelu(F.linear(x,
  W1^T, b1)), W2^T, b2))`` in bf16 (cuBLAS; it rounds the hidden and the
  pre-LN sum where the kernel does not, and is timed only);

and prints one JSON line: the times, the kernel's TF/s, the least time the
card needs (the larger of 4 M D H operations at 989 TF/s and x, out, W1,
W2 and the vectors at 3.35 TB/s), the kernel's max and mean |error|
against the plain version, its launches (by design), and the card's name
and power limit.  Runs on a CUDA device or exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from m3p_tpu_torch.bench import BF16_PEAK_FLOPS, card
from m3p_tpu_torch.ops.fused_ffn import fused_ffn_ln, reference_ffn_ln

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)


def tool_inputs(m: int, d: int, h: int):
    """x, W1 (D, H), b1, W2 (H, D), b2, gamma, beta on the card in bf16, as
    `tools/bench_fused_ffn.py:53-60` draws them."""
    rng = np.random.RandomState(0)
    x = rng.randn(m, d)
    w1 = rng.randn(d, h) * 0.02
    w2 = rng.randn(h, d) * 0.02
    arrays = (x, w1, np.zeros(h), w2, np.zeros(d), np.ones(d), np.zeros(d))
    return tuple(torch.tensor(a, dtype=torch.float32, device="cuda").to(
        torch.bfloat16) for a in arrays)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(m: int, d: int, h: int, itemsize: int):
    """(least ms, "bytes" or "operations") for one call."""
    flops = 4 * m * d * h
    n_bytes = (2 * m * d + 2 * d * h + h + 3 * d) * itemsize
    by_ops = flops / BF16_PEAK_FLOPS * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(by_ops, by_bytes),
            "operations" if by_ops >= by_bytes else "bytes", flops, n_bytes)


def run(m: int = 13120, d: int = 768, h: int = 3072, iters: int = 30
        ) -> dict:
    """The measurement on the first CUDA device, as one dict."""
    x, w1, b1, w2, b2, g, be = args = tool_inputs(m, d, h)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()

    def library():
        hidden = F.gelu(F.linear(x, w1t, b1))
        return F.layer_norm(x + F.linear(hidden, w2t, b2), (d,), g, be,
                            eps=1e-12)

    fused_ffn_ln.launches = 0
    for design in fused_ffn_ln.launches_by_design:
        fused_ffn_ln.launches_by_design[design] = 0
    got = fused_ffn_ln(*args)
    want = reference_ffn_ln(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    kernel_ms = cuda_ms(lambda: fused_ffn_ln(*args), iters)
    plain_ms = cuda_ms(lambda: reference_ffn_ln(*args), iters)
    library_ms = cuda_ms(library, iters)
    bound_ms, bound_by, flops, n_bytes = bound(m, d, h, x.element_size())
    return {
        "shape": {"M": m, "D": d, "H": h, "dtype": "bfloat16"},
        "kernel_ms": kernel_ms,
        "kernel_tflops": flops / (kernel_ms / 1e3) / 1e12,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
        "bytes": n_bytes,
        "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
        "finite": bool(torch.isfinite(got).all()),
        "launches": fused_ffn_ln.launches,
        "launches_by_design": dict(fused_ffn_ln.launches_by_design),
        "card": card(), "device": torch.cuda.get_device_name(0),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=13120)   # 80 x 164
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--h", type=int, default=3072)
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_fused_ffn: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run(args.m, args.d, args.h, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
