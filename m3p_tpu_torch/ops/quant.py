"""Frozen-weight int8 GEMMs for inference (counterpart of the inference half
of `m3p_tpu/ops/quant.py`).

At inference the weights never change, so their quantization happens
once (`prequantize_nn`, `prequantize_nt`) and a GEMM pays only for its
activations: symmetric per-row int8 with an fp32 scale, an int32
accumulation, and the output ``(acc * sx) * sw`` in the activation's dtype.
The arithmetic follows the JAX functions step for step as XLA compiles
them under ``jit`` (amax in fp32, scale = max(amax, 1e-6) / 127 computed
as the product with the fp32 reciprocal of 127, which XLA folds the
division by a constant into; round half to even; clip to +-127), so on the
CPU `int8_matmul_pre` and `int8_matmul_nt_pre` equal the jitted JAX
functions bit for bit, and the tables equal the JAX `capture_q8`'s.

These are XLA dots in JAX, not Pallas kernels: the integer GEMM is
``torch._int_mm`` (cuBLASLt on CUDA).  On CUDA it takes more than 16 rows
and K and N that are multiples of 8: fewer rows are padded with zero rows
(exact under integer accumulation), and a K or N off the rule raises; the
vocab head pads its table's rows once when it is captured
(`model/heads.py`).  A refusal never gives way to a float GEMM.

Each call adds one to ``int8_matmul_pre.calls`` (or ``int8_matmul_nt_pre``)
and to its route in ``.calls_by_route``: "int8" (the GEMM as given),
"int8_row_pad" (rows padded to `CUDA_MIN_ROWS`), "cpu".  The modules'
gate (`PREQUANT_MAX_M`) counts its decisions in `GATE_COUNTS`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

# Above this many rows the int8_infer modules take the plain GEMM (the
# JAX package's rule, `m3p_tpu/ops/quant.py:176-186`); the vocab head
# takes int8 at every M.
PREQUANT_MAX_M = 2048
# torch._int_mm on CUDA wants more rows than 16
CUDA_MIN_ROWS = 17
# a module GEMM that has an int8 table: "int8" took it, "plain" was above
# the gate and took the module's float GEMM
GATE_COUNTS = {"int8": 0, "plain": 0}

_ROUTES = ("int8", "int8_row_pad", "cpu")
# XLA computes x / 127.0 as x * (1 / 127.0) in fp32
_INV_127 = 1.0 / 127.0


def _quantize_axis(x: torch.Tensor, axis: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along ``axis``: (int8 values, fp32 scale with
    ``axis`` kept as size 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8: x (..., K) -> (int8, scale (..., 1))."""
    return _quantize_axis(x, -1)


def _quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column int8: w (K, N) -> (int8, scale (1, N))."""
    return _quantize_axis(w, 0)


def prequantize_nn(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-time quantization for `int8_matmul_pre`: w (K, N) -> (int8
    (K, N), fp32 scale (1, N))."""
    return _quantize_cols(w)


def prequantize_nt(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-time quantization for `int8_matmul_nt_pre`: w (V, K) -> (int8
    (V, K), fp32 scale (V, 1))."""
    return _quantize_axis(w, 1)


def _int_gemm(xq: torch.Tensor, wq: torch.Tensor, entry) -> torch.Tensor:
    """xq (M, K) int8 @ wq (K, N) int8 -> int32 (M, N), counted on
    ``entry``.  On CUDA, K and N must be multiples of 8 and fewer than
    `CUDA_MIN_ROWS` rows are padded with zeros."""
    m, k = xq.shape
    n = wq.shape[1]
    if xq.device.type == "cpu":
        route = "cpu"
    elif xq.device.type == "cuda":
        if k % 8 or n % 8:
            raise ValueError(
                f"the CUDA int8 GEMM takes K and N that are multiples of 8, "
                f"got K={k}, N={n}")
        route = "int8"
        if m < CUDA_MIN_ROWS:
            pad = xq.new_zeros((CUDA_MIN_ROWS - m, k))
            xq = torch.cat([xq, pad])
            route = "int8_row_pad"
    else:
        raise ValueError(f"no int8 GEMM on device {xq.device}")
    acc = torch._int_mm(xq.contiguous(), wq)
    entry.calls += 1
    entry.calls_by_route[route] += 1
    return acc[:m]


def int8_matmul_pre(x: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(wq (K, N), sw (1, N)) with per-row dynamic
    int8 activations; returns x's dtype.  ``wq`` may be a transposed view
    of a (N, K) table (the layout the CUDA GEMM reads best)."""
    lead = x.shape[:-1]
    xq, sx = _quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = _int_gemm(xq, wq, int8_matmul_pre)
    out = (acc.float() * sx) * sw
    return out.to(x.dtype).reshape(*lead, wq.shape[1])


def int8_matmul_nt_pre(x: torch.Tensor, wq: torch.Tensor,
                       sw: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(wq (V, K), sw (V, 1))^T -> (M, V): the tied vocab
    head over its int8 table; returns x's dtype."""
    xq, sx = _quantize_axis(x, 1)
    acc = _int_gemm(xq, wq.t(), int8_matmul_nt_pre)
    return ((acc.float() * sx) * sw.t()).to(x.dtype)


for _entry in (int8_matmul_pre, int8_matmul_nt_pre):
    _entry.calls = 0
    _entry.calls_by_route = dict.fromkeys(_ROUTES, 0)


def zero_counts() -> None:
    """Set every call and gate count of this module to 0."""
    for entry in (int8_matmul_pre, int8_matmul_nt_pre):
        entry.calls = 0
        entry.calls_by_route.update(dict.fromkeys(_ROUTES, 0))
    GATE_COUNTS.update(dict.fromkeys(GATE_COUNTS, 0))


def gated_linear(x: torch.Tensor, table: Optional["Q8Table"], linear,
                 bias: torch.Tensor) -> torch.Tensor:
    """A module GEMM under the frozen-weight int8 rule: through ``table``
    plus ``bias`` (in the table's dtype) when there is a table and x has at
    most `PREQUANT_MAX_M` rows; else ``linear(x)``, the module's float GEMM
    (`m3p_tpu/model/layers.py:160-171`, `:386-395`)."""
    if table is None:
        return linear(x)
    if x.numel() // x.shape[-1] > PREQUANT_MAX_M:
        GATE_COUNTS["plain"] += 1
        return linear(x)
    GATE_COUNTS["int8"] += 1
    return table(x) + bias.to(table.dtype)


class Q8Table(nn.Module):
    """The frozen int8 table of one GEMM weight, as buffers outside the
    state dict: ``wq`` (N, K) int8 quantized per output row from the weight
    cast to the compute ``dtype`` (the JAX ``kernel.astype(dtype)``,
    transposed) and ``sw`` (1, N) fp32.  ``rows`` > N pads the table with
    zero rows (scale 1) to that many, for the CUDA GEMM's N % 8 rule.
    Called on x (..., K) it is ``int8_matmul_pre(x, wq^T, sw)`` in
    ``dtype``."""

    def __init__(self, weight: torch.Tensor, dtype: torch.dtype,
                 rows: int = 0):
        super().__init__()
        self.dtype = dtype
        self.n = weight.shape[0]
        wq, sw = prequantize_nt(weight.detach().to(dtype))
        pad = max(rows - self.n, 0)
        if pad:
            wq = torch.cat([wq, wq.new_zeros((pad, wq.shape[1]))])
            sw = torch.cat([sw, sw.new_ones((pad, 1))])
        self.register_buffer("wq", wq.contiguous(), persistent=False)
        self.register_buffer("sw", sw.t().contiguous(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul_pre(x.to(self.dtype), self.wq.t(), self.sw)

    def jax_layout(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(wq (K, N), sw (1, N)) without padding: the JAX q8 collection's
        ``prequantize_nn`` layout."""
        return self.wq[:self.n].t(), self.sw[:, :self.n]
