"""int8 GEMMs of the port (counterpart of `m3p_tpu/ops/quant.py`): the
dynamic training GEMMs and the frozen-weight inference GEMMs.

Quantization is symmetric int8 with an fp32 scale along one axis, an
int32 accumulation, and the output ``(acc * s_a) * s_b`` in the
activation's dtype.  The arithmetic follows the JAX functions step for
step as XLA compiles them under ``jit`` (amax in fp32, scale = max(amax,
1e-6) / 127 computed as the product with the fp32 reciprocal of 127, which
XLA folds the division by a constant into; round half to even; clip to
+-127), so on the CPU every function here equals the jitted JAX function
bit for bit, and the captured tables equal the JAX `capture_q8`'s.

Training (`m3p_tpu/ops/quant.py:39-163`), each a `torch.autograd.Function`:
* `int8_matmul` -- x (..., K) @ w (K, N), int8 forward, straight-through
  backward in full precision (dx = g w^T, dw = x^T g in fp32, cast back);
* `int8_matmul_qbwd` -- 2-D x, int8 forward and int8 dgrad / wgrad;
* `int8_matmul_nt` -- x (M, K) @ w (N, K)^T, int8 forward, dgrad and
  wgrad: the tied vocab head.
Inference: `prequantize_nn` / `prequantize_nt` quantize a frozen weight
once, and `int8_matmul_pre` / `int8_matmul_nt_pre` pay only for their
activations.

These are XLA dots in JAX, not Pallas kernels: the integer GEMM is
``torch._int_mm`` (cuBLASLt on CUDA).  On CUDA it takes more than 16 rows
and K and N that are multiples of 8.  The training GEMMs lay out both
operands with the contraction dimension last and contiguous (the TN layout
the inference GEMMs proved on the card), quantizing straight into a
buffer that carries zero rows and columns up to the rule (exact under
integer accumulation): the token count of a wgrad and the vocabulary of
the head's dgrad are contractions too.  They lay out and pad alike on
every device, so the CPU runs the code the card runs.  The inference
GEMMs pad fewer than 17 rows on CUDA; the vocab head pads its table's rows once
when it is captured (`model/heads.py`).  A refusal never gives way to a
float GEMM.

Over a mesh the scales are those of the whole tensors (the JAX package's
GSPMD program takes each amax over every rank's part of the quantized
axis).  A quantizer whose axis is split over ranks takes its amax in fp32
over their line (`parallel.mesh.all_reduce_max`) before the clamp, so the
scale is bit for bit the whole tensor's: ``k_over`` / ``n_over`` name the
line (mesh, axes) over which a GEMM's contraction K or output N is split
(``tensor`` for a row- or column-parallel product), and the wgrads'
quantization "along the tokens" takes the line of the batch shards
(`parallel.data_parallel.batch_mesh`: ``data`` and ``fsdp``, never ``seq``,
whose blocks JAX runs in a `shard_map` manual over ``seq``), read when the
forward runs.  `AMAX_REDUCED` counts those all-reduces.  Without a mesh
nothing is reduced and the same ops run.

Each integer GEMM adds one to its entry's ``.calls`` (the function a
module called: `int8_matmul_pre`, `int8_matmul_nt_pre`, `int8_matmul`,
`int8_matmul_qbwd`, `int8_matmul_nt`) and to its route in
``.calls_by_route``: "int8" (the GEMM as given), "int8_row_pad" (rows
padded to `CUDA_MIN_ROWS`; inference), "int8_pad" (zero rows or columns
added to meet the rule; training), "cpu".  The training entries also count
``.calls_by_pass`` ("fwd", "bwd").  The modules' gate (`PREQUANT_MAX_M`)
counts its decisions in `GATE_COUNTS`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from m3p_tpu_torch.parallel import mesh as M
from m3p_tpu_torch.parallel.data_parallel import BATCH_AXES, batch_mesh
from m3p_tpu_torch.parallel.mesh import Mesh
from m3p_tpu_torch.parallel.tensor_parallel import reduce_from

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
_TRAIN_ROUTES = ("int8", "int8_pad", "cpu")
# torch._int_mm on CUDA takes K and N that are multiples of this
CUDA_ALIGN = 8
# XLA computes x / 127.0 as x * (1 / 127.0) in fp32
_INV_127 = 1.0 / 127.0

# the all-reduces of amaxes over a mesh line, and their bytes, on this rank
AMAX_REDUCED = {"calls": 0, "bytes": 0}

# a mesh line over which a quantized axis is split: (mesh, axis or axes)
Line = Optional[Tuple[Mesh, Union[str, Sequence[str]]]]


def batch_line() -> Line:
    """The line of the batch shards inside a train step
    (`parallel.data_parallel.batch_reduction`), None outside or over one
    shard: the rows of a wgrad's "along the tokens" quantization."""
    mesh = batch_mesh()
    return None if mesh is None else (mesh, BATCH_AXES)


def _amax(xf: torch.Tensor, axis: int, over: Line) -> torch.Tensor:
    """max |xf| along ``axis`` (kept as size 1), over every rank of the
    line ``over`` (module docstring).  An empty axis (a batch shard
    without rows) has amax 0."""
    if xf.shape[axis] == 0:
        shape = list(xf.shape)
        shape[axis] = 1
        amax = xf.new_zeros(shape)
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    group = None if over is None else over[0].group(over[1])
    if group is None:
        return amax
    AMAX_REDUCED["calls"] += 1
    AMAX_REDUCED["bytes"] += amax.numel() * amax.element_size()
    return M.all_reduce_max(amax, over[0], group)


def _quantize_axis(x: torch.Tensor, axis: int,
                   out: Optional[torch.Tensor] = None, over: Line = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along ``axis``: (int8 values, fp32 scale with
    ``axis`` kept as size 1), the amax taken over the line ``over``.
    ``out`` (int8, x's shape, any strides) takes the values in place of a
    new tensor."""
    xf = x.float()
    amax = _amax(xf, axis, over)
    scale = torch.clamp_min(amax, 1e-6) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    if out is None:
        return q.to(torch.int8), scale
    return out.copy_(q), scale


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


def prequantize_nt(w: torch.Tensor, k_over: Line = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-time quantization for `int8_matmul_nt_pre`: w (V, K) -> (int8
    (V, K), fp32 scale (V, 1)); ``k_over`` the line K is split over."""
    return _quantize_axis(w, 1, over=k_over)


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
                    sw: torch.Tensor, k_over: Line = None) -> torch.Tensor:
    """x (..., K) @ dequant(wq (K, N), sw (1, N)) with per-row dynamic
    int8 activations; returns x's dtype.  ``wq`` may be a transposed view
    of a (N, K) table (the layout the CUDA GEMM reads best).  With
    ``k_over`` K is this rank's part of a contraction split over that
    line: the rows' amax is taken over it, and the result is this rank's
    partial product, for the caller to sum."""
    lead = x.shape[:-1]
    xq, sx = _quantize_axis(x.reshape(-1, x.shape[-1]), -1, over=k_over)
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


# ---------------------------------------------------------------------------
# the training GEMMs
# ---------------------------------------------------------------------------


def _round_up(n: int) -> int:
    return -(-n // CUDA_ALIGN) * CUDA_ALIGN


def _operand(x: torch.Tensor, axis: int, contract: int, rows: int,
             over: Line = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (2-D) quantized along ``axis`` (its amax over the line ``over``)
    into a GEMM operand: int8 (R, Kp) with x's dimension ``contract`` (K
    long) last and contiguous, zero columns up to Kp = K rounded up to
    `CUDA_ALIGN` and zero rows up to ``rows`` (R = max(rows, x's other
    dimension)); and the scale."""
    r, k = x.shape[1 - contract], x.shape[contract]
    buf = torch.empty((max(rows, r), _round_up(k)), dtype=torch.int8,
                      device=x.device)
    buf[r:].zero_()
    buf[:r, k:].zero_()
    view = buf[:r, :k] if contract == 1 else buf[:r, :k].t()
    return buf, _quantize_axis(x, axis, out=view, over=over)[1]


def _int8_product(a: torch.Tensor, a_axis: int, a_contract: int,
                  b: torch.Tensor, b_axis: int, b_contract: int,
                  entry, pass_: str, over: Line = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int32 product of two float matrices, each quantized along its
    ``*_axis``, over their dimensions ``*_contract``: (acc (M, N), the
    scale of a, the scale of b), M and N their other dimensions.  Every
    caller quantizes both along the contraction, so ``over``, the line the
    contraction is split over, serves both amaxes.  Counted on ``entry``
    under ``pass_``."""
    m, n = a.shape[1 - a_contract], b.shape[1 - b_contract]
    qa, sa = _operand(a, a_axis, a_contract, CUDA_MIN_ROWS, over)
    qb, sb = _operand(b, b_axis, b_contract, _round_up(n), over)
    k = a.shape[a_contract]
    padded = qa.shape != (m, k) or qb.shape != (n, k)
    acc = _gemm_nt(qa, qb, entry, padded, pass_)
    return acc[:m, :n], sa, sb


def _gemm_nt(qa: torch.Tensor, qb: torch.Tensor, entry, padded: bool,
             pass_: str) -> torch.Tensor:
    """qa (M, K) @ qb (N, K)^T -> int32 (M, N), both int8 and contiguous
    (the contraction last), counted on ``entry``.  On CUDA, M must exceed
    16 and K and N be multiples of 8 (the callers pad); anything else
    raises before the GEMM.  An empty contraction (a wgrad over a batch
    shard without rows) is zeros, without a GEMM."""
    if qa.shape[1] == 0:
        return qa.new_zeros((qa.shape[0], qb.shape[0]), dtype=torch.int32)
    if qa.device.type == "cpu":
        route = "cpu"
    elif qa.device.type == "cuda":
        m, k = qa.shape
        n = qb.shape[0]
        if m < CUDA_MIN_ROWS or k % CUDA_ALIGN or n % CUDA_ALIGN:
            raise ValueError(
                f"the CUDA int8 GEMM takes more than 16 rows and K and N "
                f"that are multiples of 8, got M={m}, K={k}, N={n}")
        route = "int8_pad" if padded else "int8"
    else:
        raise ValueError(f"no int8 GEMM on device {qa.device}")
    acc = torch._int_mm(qa, qb.t())
    entry.calls += 1
    entry.calls_by_route[route] += 1
    entry.calls_by_pass[pass_] += 1
    return acc


def _int8_forward(x2d: torch.Tensor, w: torch.Tensor, entry,
                  k_over: Line) -> torch.Tensor:
    """x2d (M, K) @ w (K, N): x per row, w per column, ``(acc * sx) *
    sw`` in x's dtype (`m3p_tpu/ops/quant.py:45-51`)."""
    acc, sx, sw = _int8_product(x2d, 1, 1, w, 0, 0, entry, "fwd", k_over)
    return ((acc.float() * sx) * sw).to(x2d.dtype)


class _Int8Matmul(torch.autograd.Function):
    """int8 forward, straight-through backward in fp32
    (`m3p_tpu/ops/quant.py:39-69`)."""

    @staticmethod
    def forward(ctx, x, w, k_over):
        ctx.save_for_backward(x, w)
        x2d = x.reshape(-1, x.shape[-1])
        out = _int8_forward(x2d, w, int8_matmul, k_over)
        return out.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        g2d = g.reshape(-1, g.shape[-1]).float()
        if ctx.needs_input_grad[0]:
            dx = (g2d @ w.float().t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            x2d = x.reshape(-1, x.shape[-1]).float()
            dw = (x2d.t() @ g2d).to(w.dtype)
        return dx, dw, None


class _Int8MatmulQbwd(torch.autograd.Function):
    """int8 forward, int8 dgrad and wgrad, straight-through w.r.t. the
    quantizers (`m3p_tpu/ops/quant.py:82-114`)."""

    @staticmethod
    def forward(ctx, x, w, k_over, n_over):
        ctx.save_for_backward(x, w)
        ctx.n_over, ctx.m_over = n_over, batch_line()
        return _int8_forward(x, w, int8_matmul_qbwd, k_over)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        entry = int8_matmul_qbwd
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[m, k] = sum_n g[m, n] w[k, n]: g per row, w per row
            acc, sg, sw = _int8_product(g, 1, 1, w, 1, 1, entry, "bwd",
                                        ctx.n_over)
            dx = ((acc.float() * sg) * sw.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # dw[k, n] = sum_m x[m, k] g[m, n], computed as its transpose
            # (N, K): both along the tokens
            acc, sg, sx = _int8_product(g, 0, 0, x, 0, 0, entry, "bwd",
                                        ctx.m_over)
            dw = ((acc.float() * sx) * sg.t()).t().to(w.dtype)
        return dx, dw, None, None


class _Int8MatmulNT(torch.autograd.Function):
    """x (M, K) @ w (N, K)^T: int8 forward, dgrad and wgrad
    (`m3p_tpu/ops/quant.py:123-160`)."""

    @staticmethod
    def forward(ctx, x, w, n_over):
        ctx.save_for_backward(x, w)
        ctx.n_over, ctx.m_over = n_over, batch_line()
        acc, sx, sw = _int8_product(x, 1, 1, w, 1, 1, int8_matmul_nt, "fwd")
        return ((acc.float() * sx) * sw.t()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        entry = int8_matmul_nt
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[m, k] = sum_n g[m, n] w[n, k]: g per row, w per column
            acc, sg, sw = _int8_product(g, 1, 1, w, 0, 0, entry, "bwd",
                                        ctx.n_over)
            dx = ((acc.float() * sg) * sw).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # dw[n, k] = sum_m g[m, n] x[m, k]: both along the tokens
            acc, sg, sx = _int8_product(g, 0, 0, x, 0, 0, entry, "bwd",
                                        ctx.m_over)
            dw = ((acc.float() * sg.t()) * sx).to(w.dtype)
        return dx, dw, None


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                k_over: Line = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) through the int8 GEMM, returning x's dtype;
    straight-through gradients (g w^T and x^T g in fp32).  ``k_over``: the
    line K is split over (the result is then this rank's partial
    product)."""
    return _Int8Matmul.apply(x, w, k_over)


def int8_matmul_qbwd(x: torch.Tensor, w: torch.Tensor, k_over: Line = None,
                     n_over: Line = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) with the int8 forward and int8 dgrad / wgrad;
    x must be 2-D (callers flatten leading dimensions).  ``k_over`` /
    ``n_over``: the lines K and N are split over (a row- / column-parallel
    product); the wgrad's rows are the batch shards' (`batch_line`)."""
    if x.dim() != 2:
        raise ValueError(f"int8_matmul_qbwd takes a 2-D x, got {x.shape}")
    return _Int8MatmulQbwd.apply(x, w, k_over, n_over)


def int8_matmul_nt(x: torch.Tensor, w: torch.Tensor,
                   n_over: Line = None) -> torch.Tensor:
    """x (M, K) @ w (N, K)^T -> (M, N) with the int8 forward and int8
    dgrad / wgrad: the tied vocab head over the (V, D) word table;
    ``n_over`` the line the vocabulary N is split over."""
    return _Int8MatmulNT.apply(x, w, n_over)


_INFER_ENTRIES = (int8_matmul_pre, int8_matmul_nt_pre)
_TRAIN_ENTRIES = (int8_matmul, int8_matmul_qbwd, int8_matmul_nt)


def zero_counts() -> None:
    """Set every call and gate count of this module to 0."""
    for entry in _INFER_ENTRIES:
        entry.calls = 0
        entry.calls_by_route = dict.fromkeys(_ROUTES, 0)
    for entry in _TRAIN_ENTRIES:
        entry.calls = 0
        entry.calls_by_route = dict.fromkeys(_TRAIN_ROUTES, 0)
        entry.calls_by_pass = {"fwd": 0, "bwd": 0}
    GATE_COUNTS.update(dict.fromkeys(GATE_COUNTS, 0))


zero_counts()


def gated_linear(x: torch.Tensor, table: Optional["Q8Table"], linear
                 ) -> torch.Tensor:
    """A module GEMM under the frozen-weight int8 rule: through ``table``
    plus the Dense ``linear``'s bias (in the table's dtype, as ``linear``
    computes with it) when there is a table and x has at most
    `PREQUANT_MAX_M` rows; else ``linear(x)``, the module's float GEMM
    (`m3p_tpu/model/layers.py:160-171`, `:386-395`).  Every rank of a
    mesh line holds the same rows of x, so the line decides alike."""
    if table is None:
        return linear(x)
    if x.numel() // x.shape[-1] > PREQUANT_MAX_M:
        GATE_COUNTS["plain"] += 1
        return linear(x)
    GATE_COUNTS["int8"] += 1
    return table(x) + linear.bias_as(table.dtype)


class Q8Table(nn.Module):
    """The frozen int8 table of one GEMM weight, as buffers outside the
    state dict: ``wq`` (N, K) int8 quantized per output row from the weight
    cast to the compute ``dtype`` (the JAX ``kernel.astype(dtype)``,
    transposed) and ``sw`` (1, N) fp32.  ``rows`` > N pads the table with
    zero rows (scale 1) to that many, for the CUDA GEMM's N % 8 rule.
    Called on x (..., K) it is ``int8_matmul_pre(x, wq^T, sw)`` in
    ``dtype``.

    Over a mesh ``weight`` is this rank's part of the whole weight as the
    module computes with it: its rows (a column-parallel product's output
    columns) or, with ``row_parallel`` (the mesh), its K columns of a
    row-parallel product.  The scales are the whole weight's: a
    row-parallel table's per-row amax and, at run time, the activations'
    per-row amax are taken over ``tensor``, and the partial products are
    summed over it."""

    def __init__(self, weight: torch.Tensor, dtype: torch.dtype,
                 rows: int = 0, row_parallel: Optional[Mesh] = None):
        super().__init__()
        self.dtype = dtype
        self.n = weight.shape[0]
        self.row_parallel = row_parallel
        self.k_over: Line = (None if row_parallel is None
                             else (row_parallel, "tensor"))
        wq, sw = prequantize_nt(weight.detach().to(dtype), self.k_over)
        pad = max(rows - self.n, 0)
        if pad:
            wq = torch.cat([wq, wq.new_zeros((pad, wq.shape[1]))])
            sw = torch.cat([sw, sw.new_ones((pad, 1))])
        self.register_buffer("wq", wq.contiguous(), persistent=False)
        self.register_buffer("sw", sw.t().contiguous(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = int8_matmul_pre(x.to(self.dtype), self.wq.t(), self.sw,
                              self.k_over)
        return reduce_from(out, self.row_parallel, "tensor")

    def jax_layout(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(wq (K, N), sw (1, N)) without padding: the JAX q8 collection's
        ``prequantize_nn`` layout."""
        return self.wq[:self.n].t(), self.sw[:, :self.n]
