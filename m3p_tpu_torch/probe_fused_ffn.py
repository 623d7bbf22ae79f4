"""Probe what holds the fused FFN's "cluster" design (#9) back, on the card:

    python -m m3p_tpu_torch.probe_fused_ffn [--iters 20 --rounds 3]

It builds variants of ``csrc/fused_ffn.cu`` into ``build/probe_fused_ffn/``
(one ``nvcc -Xptxas -v`` each, all at once), each made by exact
substitutions in a copy of the source, and times the "cluster" design of
every variant in turns (each round times each variant once, with CUDA
events over ``--iters`` calls; the median round is kept) on the tool's
inputs (`bench_fused_ffn.tool_inputs`, M 13120, D 768, H 3072 bf16):

* ``shipped``: the source as it is: two ring stages, a (384, 32) slice of
  W1 (30 KB) or the chunk's (64, 384) block of W2 (49 KB), one in flight;
* ``ring3``: three stages of (256, 32) / (32, 384) (20 / 25 KB);
* ``ring4``: four stages of (128, 32) / (16, 384) (10 / 12.5 KB);
* ``no_loads``: no ``cp.async`` into the ring (the products run on whatever
  it holds);
* ``no_products``: no ``mma.sync`` and no ``ldmatrix`` (the ring's loads,
  the barriers, the exchange and the epilogue remain).

``ring3`` and ``ring4`` must equal ``shipped`` bit for bit: their sums run
in the same order.  It also times a loop of ``mma.sync`` m16n8k16 bf16 with
fp32 sums and no memory traffic, on every SM, for the most this instruction
gives on the card.  Prints one JSON line: each variant's ms, registers and
spill bytes (ptxas), the ``mma.sync`` readings and their best TF/s, the
card's name and power limit.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import statistics
import subprocess
import sys

import torch

from m3p_tpu_torch.bench import card
from m3p_tpu_torch.ops import _build
from m3p_tpu_torch.ops import fused_ffn

OUT_DIR = _build.BUILD_DIR / "probe_fused_ffn"
_RING3 = [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
          ("constexpr int kW2Rows = kHc;", "constexpr int kW2Rows = 32;"),
          ("kD % 384 == 0   ? 384", "false ? 384")]
_NO_PRODUCTS = "".join(f"\n#define {name}(...) ((void)0)" for name in (
    "mma_16816", "ldmatrix_x4", "ldmatrix_x4_trans", "ldmatrix_x2_trans"))
# (old, new) pairs; each old text must occur exactly once in the source
VARIANTS = {
    "shipped": [],
    "ring3": _RING3,
    "ring4": [("constexpr int kStages = 2;", "constexpr int kStages = 4;"),
              ("constexpr int kW2Rows = kHc;", "constexpr int kW2Rows = 16;"),
              _RING3[2], (": kD % 256 == 0 ? 256", ": false ? 256")],
    "no_loads": [("cp_async_16(dst + r * kLdw1 + c,",
                  "if (false) cp_async_16(dst + r * kLdw1 + c,"),
                 ("cp_async_16(dst + r * ldw2 + c, src + r * kD + c, true);",
                  "if (false) cp_async_16(dst + r * ldw2 + c, src + r * kD "
                  "+ c, true);")],
    "no_products": [("constexpr int kMaxD = 768;",
                     "constexpr int kMaxD = 768;" + _NO_PRODUCTS + "\n")],
}

MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include "mma.cuh"
// kAcc independent m16n8k16 products a warp, repeated iters times
template <int kAcc>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  float acc[kAcc][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) m3p::mma::mma_16816(acc[k], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) s += acc[k][0] + acc[k][1] + acc[k][2];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int m3p_probe_mma_loop(int acc, int blocks, int iters, float* out,
                                  cudaStream_t stream) {
  switch (acc) {
    case 8: mma_loop<8><<<blocks, 256, 0, stream>>>(out, iters); break;
    case 16: mma_loop<16><<<blocks, 256, 0, stream>>>(out, iters); break;
    case 24: mma_loop<24><<<blocks, 256, 0, stream>>>(out, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def variant_source(name: str, source: str) -> str:
    """``source`` with the substitutions of variant ``name``."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def registers(ptxas: str, kernel: str) -> dict:
    """Registers and spill bytes of the first entry of ptxas -v output whose
    name holds ``kernel``."""
    block = ptxas.split(kernel, 1)[1]
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       block)
    return {"registers": int(re.search(r"Used (\d+) registers",
                                       block).group(1)),
            "spill_bytes": int(spills.group(1)) + int(spills.group(2))}


def _build_one(name: str, source: str) -> tuple:
    src = OUT_DIR / f"{name}.cu"
    lib = OUT_DIR / f"lib{name}.so"
    src.write_text(source)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                           "-Xptxas", "-v", f"-I{_build.CSRC}", "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stderr


def build_all() -> dict:
    """{name: (library, ptxas output)} of every variant and the mma loop."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "fused_ffn.cu").read_text()
    sources = {n: variant_source(n, source) for n in VARIANTS}
    sources["mma_loop"] = MMA_SOURCE
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        jobs = {n: pool.submit(_build_one, n, s) for n, s in sources.items()}
        return {n: job.result() for n, job in jobs.items()}


def _timed(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def mma_ceiling(lib: ctypes.CDLL, iters: int = 4096) -> dict:
    """TF/s of the mma loop at 8, 16, 24 accumulators a warp and 1, 2
    blocks of 8 warps an SM."""
    fn = lib.m3p_probe_mma_loop
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(2 * sms * 256, device="cuda")
    readings = {}
    for per_sm in (1, 2):
        for acc in (8, 16, 24):
            blocks = per_sm * sms
            _check(fn(acc, blocks, 16, out.data_ptr(), stream), "mma loop")
            ms = _timed(lambda: _check(fn(acc, blocks, iters, out.data_ptr(),
                                          stream), "mma loop"), 1)
            flops = 4096.0 * blocks * 8 * iters * acc
            readings[f"acc{acc}_blocks{per_sm}"] = flops / (ms / 1e3) / 1e12
    return readings


def run(iters: int = 20, rounds: int = 3) -> dict:
    from m3p_tpu_torch.bench_fused_ffn import tool_inputs

    libs = build_all()
    args = tool_inputs(13120, 768, 3072)
    stream = torch.cuda.current_stream().cuda_stream
    outs, calls = {}, {}
    for name in VARIANTS:
        fn = getattr(libs[name][0], "m3p_fused_ffn_ln")
        fn.restype = ctypes.c_int
        fn.argtypes = fused_ffn._ARGTYPES
        out = outs[name] = torch.empty_like(args[0])
        ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]
        calls[name] = (lambda fn=fn, ptrs=ptrs, name=name: _check(fn(
            fused_ffn._KERNEL_DTYPES[torch.bfloat16],
            fused_ffn._DESIGNS.index("cluster"), *ptrs, 13120, 768, 3072,
            1e-12, stream), name))
        calls[name]()
    torch.cuda.synchronize()
    for name in ("ring3", "ring4"):
        if not torch.equal(outs[name], outs["shipped"]):
            raise AssertionError(f"{name} differs from the shipped design")
    readings = {name: [] for name in VARIANTS}
    for _ in range(rounds):
        for name in VARIANTS:
            readings[name].append(_timed(calls[name], iters))
    ceiling = mma_ceiling(libs["mma_loop"][0])
    return {
        "shape": {"M": 13120, "D": 768, "H": 3072, "dtype": "bfloat16"},
        "ms": {n: statistics.median(r) for n, r in readings.items()},
        "ms_rounds": readings,
        "ptxas": {n: registers(libs[n][1], "fused_ffn_ln_cluster_kernelILi6E")
                  for n in VARIANTS},
        "mma_sync_tflops": ceiling,
        "mma_sync_best_tflops": max(ceiling.values()),
        "card": card(), "device": torch.cuda.get_device_name(0),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_fused_ffn: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.iters, args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
