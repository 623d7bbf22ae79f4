"""Fused encoder FFN + LayerNorm of the port (counterpart of
`m3p_tpu/ops/fused_ffn.py`): ``LN(x + b2 + gelu_erf(x W1 + b1) W2)`` per row,
forward only.

* `reference_ffn_ln` — the plain PyTorch version, step for step the Pallas
  `_kernel` and `reference_ffn_ln` (`m3p_tpu/ops/fused_ffn.py:35-47`,
  `:87-97`): the first product summed in fp32, b1 added in fp32, the exact
  GELU, the hidden rounded to x's dtype, the second product summed in fp32,
  b2 and x added in fp32, a two-pass fp32 mean and variance, eps 1e-12,
  gamma and beta in fp32, one rounding to x's dtype.
* `fused_ffn_ln` — the dispatcher: CPU tensors take the plain version, CUDA
  tensors launch `csrc/fused_ffn.cu` (replaces the Pallas `_kernel`) in the
  design `_ffn_design` names, or raise; any other device raises.

The arguments keep the JAX order and layouts: x (M, D), W1 (D, H), b1 (H,),
W2 (H, D), b2, gamma, beta (D,), all in x's dtype (float32 or bfloat16).
"""

from __future__ import annotations

import ctypes

import torch

from m3p_tpu_torch.ops import _build
from m3p_tpu_torch.ops.activations import gelu_erf

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 1024     # the kernel's (rows, D) fp32 accumulator lives in registers
# the kernel's designs in the C entry's codes, each rule a subset of the
# one before it
_DESIGNS = ("cuda_cores", "tile32", "cluster")
CLUSTER_MAX_D = 768   # shared memory of a cluster block


def reference_ffn_ln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The plain version: (M, D) in x's dtype."""
    f32 = torch.float32
    h = gelu_erf(torch.matmul(x.to(f32), w1.to(f32)) + b1.to(f32))
    y = torch.matmul(h.to(x.dtype).to(f32), w2.to(f32))
    y = y + b2.to(f32) + x.to(f32)
    mu = y.mean(-1, keepdim=True)
    var = torch.square(y - mu).mean(-1, keepdim=True)
    out = (y - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(f32) + beta.to(f32)).to(x.dtype)


def _check_args(x, w1, b1, w2, b2, gamma, beta) -> None:
    """Raise on what the kernel does not take (on every device, so the CPU
    path refuses what the card would)."""
    tensors = (x, w1, b1, w2, b2, gamma, beta)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_ffn_ln: every argument must lie on one "
                         "device")
    if x.dtype not in _KERNEL_DTYPES or any(t.dtype != x.dtype
                                            for t in tensors):
        raise TypeError(f"fused_ffn_ln takes float32 or bfloat16 arguments "
                        f"of one dtype, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"fused_ffn_ln: x (M, D) and w1 (D, H) expected, "
                         f"got {tuple(x.shape)}, {tuple(w1.shape)}")
    d, h = w1.shape
    if (x.shape[1] != d or tuple(w2.shape) != (h, d)
            or tuple(b1.shape) != (h,)
            or any(tuple(t.shape) != (d,) for t in (b2, gamma, beta))):
        raise ValueError(
            f"fused_ffn_ln: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2/gamma/beta "
            f"{[tuple(t.shape) for t in (b2, gamma, beta)]} do not fit")
    if not 0 < d <= MAX_D or h <= 0 or h >= 2 ** 31:
        raise ValueError(f"fused_ffn_ln kernel: D={d} outside 1..{MAX_D} or "
                         f"H={h} outside 1..2^31-1")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_ffn_ln: every argument must be contiguous")


def _aligned(t: torch.Tensor, n: int) -> bool:
    return t.data_ptr() % n == 0


def _ffn_design(x, w1, w2, out) -> str:
    """The design that takes these tensors (the rule of the C entry's
    `cluster_fits` / `tile32_fits`, which refuse a launch outside it):
    "cluster" for bf16 with D % 128 == 0, D <= CLUSTER_MAX_D, H % 64 == 0
    and x, W1, W2 and out 16-byte aligned; else "tile32" for bf16 with
    D % 64 == 0, H % 8 == 0, x, W1, W2 16-byte and out 4-byte aligned;
    else "cuda_cores"."""
    if x.dtype != torch.bfloat16:
        return "cuda_cores"
    d, h = w1.shape
    if (d % 128 == 0 and d <= CLUSTER_MAX_D and h % 64 == 0
            and all(_aligned(t, 16) for t in (x, w1, w2, out))):
        return "cluster"
    if (d % 64 == 0 and h % 8 == 0 and _aligned(out, 4)
            and all(_aligned(t, 16) for t in (x, w1, w2))):
        return "tile32"
    return "cuda_cores"


def _checked_design(rule: str, forced) -> str:
    """The rule's design, or ``forced`` (the private ``_design`` argument
    that times one design against another), which may not name a design
    whose rule these tensors break."""
    if forced is None:
        return rule
    if forced not in _DESIGNS or _DESIGNS.index(forced) > _DESIGNS.index(
            rule):
        raise ValueError(f"fused_ffn_ln: design {forced!r} does not take "
                         f"these tensors (the rule names {rule!r})")
    return forced


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def _launch(x, w1, b1, w2, b2, gamma, beta, eps, _design=None
            ) -> torch.Tensor:
    """One launch of the design `_ffn_design` names; ``_design`` names
    another design whose rule the tensors meet (for timing the designs on
    the same tensors; the model path never passes it)."""
    fn = _build.bind("fused_ffn", "m3p_fused_ffn_ln", _ARGTYPES)
    m, d = x.shape
    out = torch.empty_like(x)
    design = _checked_design(_ffn_design(x, w1, w2, out), _design)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_KERNEL_DTYPES[x.dtype], _DESIGNS.index(design),
                 x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 out.data_ptr(), m, d, w1.shape[1], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused_ffn_ln kernel ({design}) launch failed: "
                           f"CUDA error {err}")
    fused_ffn_ln.launches += 1
    fused_ffn_ln.launches_by_design[design] += 1
    return out


def cluster_occupancy(d: int) -> int:
    """The most two-block clusters of the "cluster" design at width ``d``
    that the current card runs at once (cudaOccupancyMaxActiveClusters)."""
    fn = _build.bind("fused_ffn", "m3p_fused_ffn_ln_cluster_occupancy",
                     [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    err = fn(d, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cluster occupancy query failed: CUDA error "
                           f"{err}")
    return n.value


def fused_ffn_ln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``LN(x + b2 + gelu_erf(x W1 + b1) W2)``, (M, D) in x's dtype; forward
    only.  CPU tensors take `reference_ffn_ln`; CUDA tensors launch the
    kernel in the design `_ffn_design` names, adding one to
    ``fused_ffn_ln.launches`` and to that design's entry of
    ``fused_ffn_ln.launches_by_design``, or raise; other devices raise.
    The JAX function's row tile ``tm`` has no counterpart: each design
    has its own.  M = 0 returns an empty tensor without a launch."""
    _check_args(x, w1, b1, w2, b2, gamma, beta)
    if x.device.type == "cpu":
        return reference_ffn_ln(x, w1, b1, w2, b2, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_ln: no kernel for device {x.device}")
    if x.shape[0] == 0:
        return torch.empty_like(x)
    return _launch(x, w1, b1, w2, b2, gamma, beta, eps)


fused_ffn_ln.launches = 0
fused_ffn_ln.launches_by_design = dict.fromkeys(_DESIGNS, 0)
