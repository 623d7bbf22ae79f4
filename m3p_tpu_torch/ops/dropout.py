"""Fused residual dropout of the port (counterpart of
`m3p_tpu/ops/dropout.py`): ``residual + dropout(x)`` in one elementwise
pass, the mask regenerated from the seed in the backward and never stored.

Numerics follow the TPU kernels (`_fwd_kernel`/`_bwd_kernel`,
`m3p_tpu/ops/dropout.py:35-48`):

    out   = residual + where(keep, x * scale, 0)
    scale = 1 / (1 - rate), rounded to x's dtype first (1.109375 in bf16 at
            rate 0.1, 0.16 % under 1/0.9)

with the product and the sum each rounded to x's dtype.  The keep mask is
`ops.philox.keep_mask_flat`: element i of the flat tensor takes word i % 4
of Philox4x32-10 at counter (i // 4 lo, i // 4 hi, 0, 0), kept at or above
`keep_threshold(rate)`.

Kernels (`csrc/fused_dropout.cu`): #7 ``fused_dropout_add_kernel`` for the
forward of `dropout_add`, #8 ``fused_dropout_scale_kernel`` for its backward
and both directions of `dropout_scale`, each in the design
`_dropout_design` names by the pointers' alignment ("wide", "narrow",
"scalar").  CPU tensors take the plain versions below, which round at the
same places, so kernel and plain version agree bit for bit; CUDA tensors
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from m3p_tpu_torch.ops import _build
from m3p_tpu_torch.ops.philox import keep_mask_flat, keep_threshold, seed_key

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' designs in the C entry's width codes, each rule a subset of
# the one before it
_DESIGNS = ("scalar", "narrow", "wide")


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")


def _scale(rate: float, dtype: torch.dtype) -> torch.Tensor:
    """1 / (1 - rate) in ``dtype``, as a 0-d tensor."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=dtype)


def dropout_scale_reference(x: torch.Tensor, seed: int,
                            rate: float) -> torch.Tensor:
    """The plain version of #8: where(keep, x * scale, 0) in x's dtype."""
    _check_rate(rate)
    keep = keep_mask_flat(seed, x.numel(), rate, device=x.device)
    scaled = x * _scale(rate, x.dtype)
    return torch.where(keep.view(x.shape), scaled, scaled.new_zeros(()))


def dropout_add_reference(x: torch.Tensor, residual: torch.Tensor, seed: int,
                          rate: float) -> torch.Tensor:
    """The plain version of #7: residual + where(keep, x * scale, 0), every
    step in x's dtype."""
    _check_pair(x, residual)
    return residual + dropout_scale_reference(x, seed, rate)


def _check_pair(x: torch.Tensor, residual: torch.Tensor) -> None:
    if x.shape != residual.shape or x.dtype != residual.dtype \
            or x.device != residual.device:
        raise ValueError(
            f"dropout_add: x {tuple(x.shape)} {x.dtype} on {x.device} and "
            f"residual {tuple(residual.shape)} {residual.dtype} on "
            f"{residual.device} must match")


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


_ADD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_uint,
                    ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p])
_SCALE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p])


def _kernel_input(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{t.dtype}")
    return t.contiguous()


def _dropout_design(*tensors: torch.Tensor) -> str:
    """The design that takes these tensors (every one the kernel reads or
    writes), by the alignment of their data: "wide" when every pointer is
    16-byte aligned, "narrow" when every one is aligned to 4 elements (in
    bf16 8 bytes; in fp32 that is 16 bytes, so "wide" takes it), else
    "scalar".  The rule of the C entry, which refuses a width the pointers
    do not allow."""
    if all(t.data_ptr() % 16 == 0 for t in tensors):
        return "wide"
    if all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors):
        return "narrow"
    return "scalar"


def _launch(x: torch.Tensor, residual, seed: int, rate: float,
            _design=None) -> torch.Tensor:
    """#7 when ``residual`` is a tensor, #8 when it is None, in the design
    `_dropout_design` names; adds one to ``dropout_add.launches`` or
    ``dropout_add.bwd_launches`` and to that design's entry of
    ``dropout_add.launches_by_design`` or ``.bwd_launches_by_design``.
    ``_design`` names a narrower design the pointers allow (for timing the
    designs on the same tensors; the model path never passes it)."""
    what = "dropout_add" if residual is not None else "dropout_scale"
    x = _kernel_input(x, what)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tensors = [x, out] if residual is None else [x, residual, out]
    rule = _dropout_design(*tensors)
    design = rule if _design is None else _design
    if design not in _DESIGNS or _DESIGNS.index(design) > _DESIGNS.index(
            rule):
        raise ValueError(f"{what}: design {design!r} does not take these "
                         f"tensors (the rule names {rule!r})")
    args = (float(_scale(rate, x.dtype)), keep_threshold(rate), int(seed),
            _DESIGNS.index(design))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if residual is None:
            fn = _build.bind("fused_dropout", "m3p_fused_dropout_scale",
                             _SCALE_ARGTYPES)
            err = fn(_KERNEL_DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
                     x.numel(), *args, stream)
        else:
            fn = _build.bind("fused_dropout", "m3p_fused_dropout_add",
                             _ADD_ARGTYPES)
            err = fn(_KERNEL_DTYPES[x.dtype], x.data_ptr(),
                     residual.data_ptr(), out.data_ptr(), x.numel(), *args,
                     stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel ({design}) launch failed: CUDA "
                           f"error {err}")
    if residual is None:
        dropout_add.bwd_launches += 1
        dropout_add.bwd_launches_by_design[design] += 1
    else:
        dropout_add.launches += 1
        dropout_add.launches_by_design[design] += 1
    return out


def _scale_apply(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """where(keep, x * scale, 0): the plain version for CPU tensors, #8 for
    CUDA tensors, else raise."""
    if x.device.type == "cpu":
        return dropout_scale_reference(x, seed, rate)
    if x.device.type != "cuda":
        raise ValueError(f"dropout_scale: no kernel for device {x.device}")
    return _launch(x, None, seed, rate)


# ---------------------------------------------------------------------------
# the differentiable wrappers
# ---------------------------------------------------------------------------


class _DropoutAdd(torch.autograd.Function):
    """The `jax.custom_vjp` of `dropout_add` (`m3p_tpu/ops/dropout.py:
    79-112`): saves only the seed; the backward is (dropout(g), g) with the
    mask regenerated."""

    @staticmethod
    def forward(ctx, x, residual, seed, rate):
        ctx.config = (seed, rate)
        if x.device.type == "cpu":
            return dropout_add_reference(x, residual, seed, rate)
        return _launch(_kernel_input(x, "dropout_add"),
                       _kernel_input(residual, "dropout_add"), seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _scale_apply(g, *ctx.config), g, None, None


class _DropoutScale(torch.autograd.Function):
    """The `jax.custom_vjp` of `dropout_scale` (`:115-140`): #8 in both
    directions."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.config = (seed, rate)
        return _scale_apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _scale_apply(g, *ctx.config), None, None


def _check_args(x: torch.Tensor, seed: int, rate: float) -> None:
    _check_rate(rate)
    seed_key(seed)          # raises unless a 64-bit unsigned int
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused dropout: no kernel for device {x.device}")


def dropout_add(x: torch.Tensor, residual: torch.Tensor, seed: int,
                rate: float) -> torch.Tensor:
    """residual + dropout(x, rate) under the Philox mask of ``seed`` (a
    64-bit int); differentiable in x and residual.  CPU tensors take the
    plain version; CUDA tensors launch #7 (forward) and #8 (backward),
    adding one to ``dropout_add.launches`` per #7 launch and to
    ``dropout_add.bwd_launches`` per #8 launch (and to the design's entry
    of ``.launches_by_design`` / ``.bwd_launches_by_design``), or raise."""
    _check_args(x, seed, rate)
    _check_pair(x, residual)
    return _DropoutAdd.apply(x, residual, int(seed), float(rate))


def dropout_scale(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """dropout(x, rate) without a residual, #8 in both directions (plain
    versions for CPU tensors)."""
    _check_args(x, seed, rate)
    return _DropoutScale.apply(x, int(seed), float(rate))


def fused_dropout_add(x: torch.Tensor, residual: torch.Tensor, seed: int,
                      rate: float, deterministic: bool = False
                      ) -> torch.Tensor:
    """The dispatcher (`m3p_tpu/ops/dropout.py:143-157`): ``residual + x``
    when deterministic or at rate 0, else `dropout_add`.  Unlike the JAX
    dispatcher there is no fallback onto another generator: CUDA tensors
    launch the kernels, CPU tensors take the plain version of the same
    mask."""
    if deterministic or rate == 0.0:
        return residual + x
    return dropout_add(x, residual, seed, rate)


dropout_add.launches = 0
dropout_add.bwd_launches = 0
dropout_add.launches_by_design = dict.fromkeys(_DESIGNS, 0)
dropout_add.bwd_launches_by_design = dict.fromkeys(_DESIGNS, 0)

