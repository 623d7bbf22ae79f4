"""Multi-head attention of the port (counterpart of `m3p_tpu/ops/attention.py`).

* `mha_reference` — (B, H, S, D) attention with an fp32 softmax, the
  numerical ground truth of the JAX package.
* `attention_flash_reference` — the plain PyTorch forward of every
  attention kernel (also named `attention_packed_reference`): q/k/v/out in
  the projection layout (B, S, H*Dh), attention-weight dropout from the
  Philox keep mask of `ops/philox.py`, query rows in chunks.
* `attention_packed_bwd_reference` — the plain backward of the packed
  kernel (recomputes the softmax), `attention_flash_bwd_reference` that of
  the flash kernel (from the forward's output and row statistics).
* `attention_packed` — the differentiable, dispatching wrapper, and
  `attention_packed_bwd`, its dispatching backward.  CPU tensors take the
  plain forward and backward; CUDA tensors launch `csrc/packed_attention.cu`
  (replaces the Pallas `_packed_fwd_kernel`) and `csrc/packed_attention_bwd.cu`
  (replaces `_packed_bwd_kernel`); each has two designs, bf16 on the tensor
  cores and any dtype on CUDA cores, and `_packed_design` names the one a
  call takes.  Anything else raises.
* `attention_flash` / `attention_flash_bwd` — the dispatching wrappers over
  `csrc/flash_attention.cu` (replaces the Pallas `_flash_kernel`) and
  `csrc/flash_attention_bwd.cu` (replaces `_flash_bwd_dkv_kernel` and
  `_flash_bwd_dq_kernel`); each holds the two designs, and `_flash_design`
  names the one a call takes.
* `attention` — the model's entry: packed kernels up to MAX_SEQ, flash
  kernels above, as the JAX module dispatches.
* `small_attention_reference` / `small_attention_bwd_reference` — the plain
  forward and backward of the head-major single-tile kernels (q (B, H, Sq,
  D), k/v (B, H, Sk, D)); `small_attention` / `small_attention_bwd` their
  dispatching wrappers over `csrc/small_attention.cu` (replaces the Pallas
  `_small_fwd_kernel` and `_small_bwd_kernel`; both in the packed kernels'
  two designs, `_small_design`).
* `attention_bhsd` — the head-major entry (the JAX `attention`): with
  dropout the single-tile kernels up to MAX_SEQ and the flash kernels above;
  at rate 0 the flash kernels from a key length of PALLAS_MIN_KV_LEN and
  `mha_reference` below it.

Masking follows the JAX package: a masked score becomes the finite value
-0.7 * float32 max, so a row with no valid key averages v instead of giving
NaN; ``causal`` aligns the diagonal at the end (q is the suffix of k).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from m3p_tpu_torch.ops import _build
from m3p_tpu_torch.ops.philox import (
    head_tiles, keep_mask_tiles, keep_threshold, seed_key)

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

MAX_SEQ = 512      # Sq, Sk limit of the packed kernels (single-pass softmax)
MAX_HEAD_DIM = 128

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the designs of the kernels that have two, in the C entries' codes
_DESIGNS = ("cuda_cores", "tensor_cores")


def _tensor_cores_fit(dh: int, tensors, n_strides: int) -> bool:
    """The rule of `tc_fits` in `csrc/flash_tile.cuh`: bf16 (q, the first
    tensor), a head dim that is a multiple of 16 up to MAX_HEAD_DIM, and
    for every tensor 16-byte aligned data and leading ``n_strides``
    strides that are multiples of 8 elements, so that every head's row
    starts on 16 bytes (cp.async, ldmatrix)."""
    if tensors[0].dtype != torch.bfloat16 or dh % 16 or dh > MAX_HEAD_DIM:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:n_strides])
               for t in tensors)


def _attended(kv_mask: Optional[torch.Tensor], causal: bool, sq: int,
              sk: int, device, r0: int = 0,
              r1: Optional[int] = None) -> Optional[torch.Tensor]:
    """Bool (B or 1, 1, r1 - r0, Sk), True where query rows r0 .. r1 - 1
    (all Sq rows by default) attend to a key, or None when nothing is
    masked."""
    valid = None
    if kv_mask is not None:
        valid = kv_mask.bool()[:, None, None, :]
    if causal:
        r1 = sq if r1 is None else r1
        qi = torch.arange(r0, r1, device=device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=device)[None, :]
        tri = (ki <= qi)[None, None]
        valid = tri if valid is None else valid & tri
    return valid


def _masked_scores(scores: torch.Tensor, kv_mask: Optional[torch.Tensor],
                   causal: bool) -> torch.Tensor:
    """scores (B, H, Sq, Sk) fp32 -> scores with masked entries replaced."""
    valid = _attended(kv_mask, causal, scores.shape[-2], scores.shape[-1],
                      scores.device)
    if valid is None:
        return scores
    return scores.masked_fill(~valid, DEFAULT_MASK_VALUE)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor] = None,
                  causal: bool = False,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, H, Sk, D), kv_mask (B, Sk) True = attend."""
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(_masked_scores(scores, kv_mask, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def _check_dropout(dropout_rate: float, dropout_seed: Optional[int]) -> None:
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"attention dropout_rate {dropout_rate} outside "
                         f"[0, 1)")
    if dropout_rate > 0.0 and dropout_seed is None:
        # a default seed would draw the same mask on every call: dropout
        # as a fixed sparsity pattern (`m3p_tpu/ops/attention.py:969`)
        raise ValueError("attention dropout_rate > 0 requires an explicit "
                         "dropout_seed (draw one per call from your "
                         "generator; a missing seed would reuse one mask)")


def _probs(q, k, kv_mask, n_heads, causal, scale):
    """Packed q (B, Sq, H*Dh), k (B, Sk, H*Dh) -> fp32 softmax weights
    (B, H, Sq, Sk)."""
    b, sq, hd = q.shape
    dh = hd // n_heads
    qh = q.reshape(b, sq, n_heads, dh)
    kh = k.reshape(b, k.shape[1], n_heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    return torch.softmax(_masked_scores(scores, kv_mask, causal), dim=-1)


def _keep(dropout_seed, dropout_rate, b, n_heads, sq, sk, device,
          head_base=0, heads_total=None):
    """The kernels' keep mask of every (batch, head) tile: (B, H, Sq, Sk),
    the heads those of `head_tiles`."""
    tiles = head_tiles(b, n_heads, head_base, heads_total, device)
    return keep_mask_tiles(dropout_seed, b * n_heads, sq, sk, dropout_rate,
                           device, tiles=tiles).view(b, n_heads, sq, sk)


def _scale(sm_scale: Optional[float], dh: int) -> float:
    return sm_scale if sm_scale is not None else 1.0 / (dh ** 0.5)


# query rows per pass of the plain versions: bounds their (B, H, rows, Sk)
# temporaries (fp32, and the int64 Philox words at rate > 0)
FLASH_ROW_CHUNK = 512


def _flash_scores(q, k, kv_mask, n_heads, causal, scale, r0, r1):
    """Masked fp32 scores (B, H, r1 - r0, Sk) of query rows r0 .. r1 - 1
    and the attend mask of those rows (or None)."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    dh = hd // n_heads
    qh = q[:, r0:r1].reshape(b, r1 - r0, n_heads, dh)
    kh = k.reshape(b, sk, n_heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    valid = _attended(kv_mask, causal, sq, sk, q.device, r0, r1)
    if valid is not None:
        s = s.masked_fill(~valid, DEFAULT_MASK_VALUE)
    return s, valid


def _flash_keep(dropout_seed, dropout_rate, b, n_heads, r0, r1, sk, device,
                head_base=0, heads_total=None):
    """The Philox keep mask of rows r0 .. r1 - 1 of every (batch, head)
    tile: (B, H, r1 - r0, Sk), the same bits the packed kernels draw."""
    tiles = head_tiles(b, n_heads, head_base, heads_total, device)
    return keep_mask_tiles(dropout_seed, b * n_heads, r1 - r0, sk,
                           dropout_rate, device, first_row=r0,
                           tiles=tiles).view(b, n_heads, r1 - r0, sk)


def attention_flash_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor], n_heads: int,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None,
                              return_stats: bool = False,
                              head_base: int = 0,
                              heads_total: Optional[int] = None):
    """Plain version of the flash forward, in the packed layout: q
    (B, Sq, H*Dh), k/v (B, Sk, H*Dh) -> (B, Sq, H*Dh) in v's dtype, any
    lengths.  The math of `mha_reference` (masked scores take the finite
    mask value, so a row without any valid key averages v over Sk) plus
    the Philox keep mask of tile b*H + h over the global (row, col) with
    the 1/(1 - rate) scale (of tile b * heads_total + head_base + h when
    the call holds the heads head_base .. head_base + H - 1 of a tensor of
    ``heads_total``: a tensor-parallel rank's heads draw what the whole
    tensor's call draws for them); the weights are rounded to v's dtype before
    P.V, which sums in fp32.  Query rows go in chunks of FLASH_ROW_CHUNK.

    ``return_stats`` also returns the per-row softmax statistics (B, H,
    Sq, 2) fp32: the row max m and the sum l of exp(s - m), which
    `attention_flash_bwd` reads (the (l, m) residuals of
    `m3p_tpu/ops/attention.py:313`)."""
    _check_dropout(dropout_rate, dropout_seed)
    b, sq, hd = q.shape
    sk = k.shape[1]
    dh = hd // n_heads
    scale = _scale(sm_scale, dh)
    inv = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0.0 else 1.0
    vh = v.reshape(b, sk, n_heads, dh).float()
    out = torch.empty((b, sq, hd), dtype=v.dtype, device=q.device)
    stats = torch.empty((b, n_heads, sq, 2), dtype=torch.float32,
                        device=q.device)
    for r0 in range(0, sq, FLASH_ROW_CHUNK):
        r1 = min(sq, r0 + FLASH_ROW_CHUNK)
        s, _ = _flash_scores(q, k, kv_mask, n_heads, causal, scale, r0, r1)
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(-1, keepdim=True)
        p = e / l
        if dropout_rate > 0.0:
            keep = _flash_keep(dropout_seed, dropout_rate, b, n_heads, r0, r1,
                               sk, q.device, head_base, heads_total)
            p = p.masked_fill(~keep, 0.0)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vh) * inv
        out[:, r0:r1] = o.reshape(b, r1 - r0, hd).to(v.dtype)
        stats[:, :, r0:r1, 0] = m[..., 0]
        stats[:, :, r0:r1, 1] = l[..., 0]
    return (out, stats) if return_stats else out


# The packed kernels compute the same function on shorter sequences: their
# plain version is this one.
attention_packed_reference = attention_flash_reference


def attention_packed_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   kv_mask: Optional[torch.Tensor],
                                   do: torch.Tensor, n_heads: int,
                                   causal: bool = False,
                                   sm_scale: Optional[float] = None,
                                   dropout_rate: float = 0.0,
                                   dropout_seed: Optional[int] = None,
                                   head_base: int = 0,
                                   heads_total: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the packed backward (the heads' keep masks as in
    `attention_flash_reference`): (dq, dk, dv) in the layouts and
    dtypes of q, k, v.  A transcription of `_packed_bwd_kernel`
    (`m3p_tpu/ops/attention.py:1036-1081`): recompute p, then

        dv = inv * (keep.p)^T dO           dp = dO V^T
        r  = rowsum(keep.p.dp)             ds = p . (keep.dp - r)
        dk = scale * inv * ds^T Q          dq = scale * inv * ds K

    with inv = 1/(1 - rate); the products take operands rounded to the
    input type and sum in fp32 (``preferred_element_type=float32``).
    Masked scores get no gradient (ds = 0 there), as in the vjp of
    `mha_reference`.  This differs from the Pallas kernel only on a row
    with no valid key, where p is uniform: the Pallas kernel lets dq and dk
    of that row through the masked scores (ROADMAP section 3)."""
    _check_dropout(dropout_rate, dropout_seed)
    b, sq, hd = q.shape
    sk = k.shape[1]
    dh = hd // n_heads
    scale = _scale(sm_scale, dh)
    inv = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0.0 else 1.0
    p = _probs(q, k, kv_mask, n_heads, causal, scale)
    qh, doh = (t.reshape(b, sq, n_heads, dh).float() for t in (q, do))
    kh, vh = (t.reshape(b, sk, n_heads, dh).float() for t in (k, v))
    dp = torch.einsum("bqhd,bkhd->bhqk", doh.to(v.dtype).float(), vh)
    if dropout_rate > 0.0:
        keep = _keep(dropout_seed, dropout_rate, b, n_heads, sq, sk, q.device,
                     head_base, heads_total)
        pd = p.masked_fill(~keep, 0.0)
        dpd = dp.masked_fill(~keep, 0.0)
    else:
        pd, dpd = p, dp
    r = (pd * dp).sum(-1, keepdim=True)
    ds = p * (dpd - r)
    valid = _attended(kv_mask, causal, sq, sk, q.device)
    if valid is not None:
        ds = ds.masked_fill(~valid, 0.0)

    def rounded(x, dtype):
        return x.to(dtype).float()

    dv = torch.einsum("bhqk,bqhd->bkhd", rounded(pd, do.dtype), doh) * inv
    dk = torch.einsum("bhqk,bqhd->bkhd", rounded(ds, q.dtype), qh) \
        * (scale * inv)
    dq = torch.einsum("bhqk,bkhd->bqhd", rounded(ds, k.dtype), kh) \
        * (scale * inv)
    return (dq.reshape(b, sq, hd).to(q.dtype),
            dk.reshape(b, sk, hd).to(k.dtype),
            dv.reshape(b, sk, hd).to(v.dtype))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _check_device_and_dtype(q, k, v, kv_mask, what):
    tensors = (q, k, v) if kv_mask is None else (q, k, v, kv_mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: q, k, v and kv_mask must lie on one "
                         f"device")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_kernel_args(q, k, v, kv_mask, n_heads, max_seq=MAX_SEQ,
                       what="attention_packed"):
    """Raise on what the kernels do not take; ``max_seq`` None = any
    length (the flash kernels)."""
    _check_device_and_dtype(q, k, v, kv_mask, what)
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{what}: q (B, Sq, H*Dh) and k/v (B, Sk, H*Dh) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hd = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != hd or hd % n_heads:
        raise ValueError(f"{what}: shapes {tuple(q.shape)} / "
                         f"{tuple(k.shape)} do not fit {n_heads} heads")
    if hd // n_heads > MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel: head dim {hd // n_heads} > "
                         f"{MAX_HEAD_DIM}")
    limit = max_seq if max_seq is not None else 2 ** 31 - 1
    if not (0 < sq <= limit and 0 < sk <= limit):
        raise ValueError(f"{what} kernel: Sq={sq}, Sk={sk} outside "
                         f"1..{limit}")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"{what} kernel: grid too large")
    if any(t.stride(2) != 1 for t in (q, k, v)):
        raise ValueError(f"{what} kernel: the last dimension of q/k/v must "
                         f"be contiguous")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, sk):
        raise ValueError(f"{what}: kv_mask shape {tuple(kv_mask.shape)} != "
                         f"{(b, sk)}")


_FWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                    ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 14
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                    ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p])


def _kernel_mask(kv_mask):
    return None if kv_mask is None else kv_mask.to(torch.bool).contiguous()


def _dropout_args(dropout_rate, dropout_seed, n_heads, head_base=0,
                  heads_total=None):
    """(inv, threshold, seed, head_base, heads_total) for the kernels:
    inv, threshold and seed are zero at rate 0; the Philox tile of (b, h)
    is b * heads_total + head_base + h (`head_tiles`)."""
    heads_total = n_heads if heads_total is None else int(heads_total)
    if not 0 <= head_base <= heads_total - n_heads:
        raise ValueError(f"heads {head_base} .. {head_base + n_heads - 1} "
                         f"are not heads of a tensor of {heads_total}")
    if dropout_rate <= 0.0:
        return 1.0, 0, 0, int(head_base), heads_total
    seed_key(dropout_seed)      # raises unless a 64-bit unsigned int
    return (1.0 / (1.0 - dropout_rate), keep_threshold(dropout_rate),
            int(dropout_seed), int(head_base), heads_total)


def _launch_fwd(q, k, v, kv_mask, n_heads, causal, scale, dropout_rate,
                dropout_seed, _design=None, head_base=0, heads_total=None
                ) -> torch.Tensor:
    """One launch of the design `_packed_design` names; ``_design``
    "cuda_cores" takes the CUDA-core design instead (for timing the two
    designs on the same tensors; the model path never passes it)."""
    fn = _build.bind("packed_attention", "m3p_packed_attention_fwd",
                     _FWD_ARGTYPES)
    b, sq, hd = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    design = _checked_design(_packed_design(n_heads, q, k, v, out), _design,
                             "attention_packed")
    mask = _kernel_mask(kv_mask)
    inv, *philox = _dropout_args(dropout_rate, dropout_seed, n_heads,
                                 head_base, heads_total)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KERNEL_DTYPES[q.dtype], _DESIGNS.index(design),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), b, sq, sk, n_heads, hd // n_heads,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 float(scale), int(bool(causal)), float(inv), *philox,
                 stream)
    if err != 0:
        raise RuntimeError(f"packed_attention kernel ({design}) launch "
                           f"failed: CUDA error {err}")
    attention_packed.launches += 1
    attention_packed.launches_by_design[design] += 1
    return out


def _packed_design(n_heads: int, *tensors: torch.Tensor) -> str:
    """The design of the packed forward and backward that takes these
    (B, S, H*Dh) tensors (q first; every tensor the kernel reads or
    writes): "tensor_cores" where `_flash_design` names them and every S is
    at most MAX_SEQ, else "cuda_cores".  The rule of the C entries
    (`csrc/packed_tile.cuh`, `csrc/packed_tile_bwd.cuh`), which refuse a
    tensor-core launch that breaks it."""
    if all(t.shape[1] <= MAX_SEQ for t in tensors):
        return _flash_design(n_heads, *tensors)
    return "cuda_cores"


def _checked_design(rule: str, forced: Optional[str], what: str) -> str:
    """The design a launch of the single-tile kernels takes: the rule's, or
    ``forced`` (the private ``_design`` argument that times one design
    against the other), which may not name the tensor cores where the rule
    does not."""
    if forced is None:
        return rule
    if forced not in _DESIGNS or (forced == "tensor_cores"
                                  and rule != "tensor_cores"):
        raise ValueError(f"{what}: design {forced!r} does not take these "
                         f"tensors (the rule names {rule!r})")
    return forced


def _bwd_scratch(q, sq, sk, n_heads, design, threshold):
    """The backward's scratch: the (B, H, Sq, 3) fp32 row statistics and,
    with dropout on the tensor cores, the (B, H, Sq, ceil(Sk / 32)) keep
    words that phase 0 draws for phase 1 (else None)."""
    b = q.shape[0]
    stats = torch.empty((b, n_heads, sq, 3), dtype=torch.float32,
                        device=q.device)
    bits = None
    if design == "tensor_cores" and threshold:
        bits = torch.empty((b, n_heads, sq, (sk + 31) // 32),
                           dtype=torch.int32, device=q.device)
    return stats, bits


def _launch_bwd(q, k, v, kv_mask, do, n_heads, causal, scale, dropout_rate,
                dropout_seed, _design=None, head_base=0, heads_total=None
                ) -> Tuple[torch.Tensor, ...]:
    """Two launches of the design `_packed_design` names: dq (and the
    per-row softmax statistics m, l, r into a (B, H, Sq, 3) fp32
    scratch), then dk/dv, which reads them.  ``_design`` "cuda_cores"
    takes the CUDA-core design instead (for timing the two designs on the
    same tensors; the model path never passes it)."""
    fn = _build.bind("packed_attention_bwd", "m3p_packed_attention_bwd",
                     _BWD_ARGTYPES)
    b, sq, hd = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    design = _checked_design(_packed_design(n_heads, q, k, v, do, dq, dk,
                                            dv),
                             _design, "attention_packed backward")
    mask = _kernel_mask(kv_mask)
    inv, *philox = _dropout_args(dropout_rate, dropout_seed, n_heads,
                                 head_base, heads_total)
    stats, bits = _bwd_scratch(q, sq, sk, n_heads, design, philox[0])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            None if bits is None else bits.data_ptr(),
            b, sq, sk, n_heads, hd // n_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
            dv.stride(0), dv.stride(1),
            float(scale), int(bool(causal)), float(inv), *philox)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for phase in (0, 1):
            err = fn(_KERNEL_DTYPES[q.dtype], _DESIGNS.index(design), phase,
                     *args, stream)
            if err != 0:
                raise RuntimeError(f"packed_attention backward kernel "
                                   f"({design}, phase {phase}) launch "
                                   f"failed: CUDA error {err}")
            attention_packed.bwd_launches += 1
            attention_packed.bwd_launches_by_design[design] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the differentiable wrapper
# ---------------------------------------------------------------------------


class _PackedAttention(torch.autograd.Function):
    """The counterpart of the `jax.custom_vjp` at
    `m3p_tpu/ops/attention.py:1196-1229`: saves q, k, v, the key mask and
    the seed (never p), and the backward recomputes everything."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, n_heads, causal, scale, dropout_rate,
                dropout_seed, heads):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.config = (n_heads, causal, scale, dropout_rate, dropout_seed,
                      *heads)
        if q.device.type == "cpu":
            return attention_packed_reference(q, k, v, kv_mask, n_heads,
                                              causal, scale, dropout_rate,
                                              dropout_seed, False, *heads)
        return _launch_fwd(q, k, v, kv_mask, n_heads, causal, scale,
                           dropout_rate, dropout_seed, None, *heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask = ctx.saved_tensors
        grads = attention_packed_bwd(q, k, v, kv_mask, do, *ctx.config)
        return (*grads, None, None, None, None, None, None, None)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_mask: Optional[torch.Tensor], n_heads: int,
                     causal: bool = False, sm_scale: Optional[float] = None,
                     dropout_rate: float = 0.0,
                     dropout_seed: Optional[int] = None,
                     head_base: int = 0,
                     heads_total: Optional[int] = None) -> torch.Tensor:
    """Packed-layout attention: q (B, Sq, H*Dh), k/v (B, Sk, H*Dh), kv_mask
    (B, Sk) True = attend -> (B, Sq, H*Dh) in q's dtype; differentiable in
    q, k and v.

    ``dropout_rate`` > 0 drops attention weights with the Philox mask of
    ``dropout_seed`` (a 64-bit int, required) and scales by 1/(1 - rate).
    The H heads are heads ``head_base`` .. ``head_base + H - 1`` of a
    tensor of ``heads_total`` (default H): each draws the mask the whole
    tensor's call draws for it (`head_tiles`).
    CPU tensors go through the plain forward and backward; CUDA tensors
    launch the hand-written kernels, adding one to
    ``attention_packed.launches`` per forward launch and to
    ``attention_packed.bwd_launches`` per backward launch (two per
    backward), and to the design's entry of
    ``attention_packed.launches_by_design`` /
    ``.bwd_launches_by_design`` (`_packed_design`), or raise.  There is no
    fallback from one to the other, nor from one design to the other."""
    _check_dropout(dropout_rate, dropout_seed)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_packed: no kernel for device "
                         f"{q.device}")
    if q.device.type == "cuda":
        _check_kernel_args(q, k, v, kv_mask, n_heads)
    scale = _scale(sm_scale, q.shape[-1] // n_heads)
    return _PackedAttention.apply(q, k, v, kv_mask, n_heads, bool(causal),
                                  scale, float(dropout_rate), dropout_seed,
                                  (head_base, heads_total))


def attention_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: Optional[torch.Tensor], do: torch.Tensor,
                         n_heads: int, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         dropout_rate: float = 0.0,
                         dropout_seed: Optional[int] = None,
                         head_base: int = 0,
                         heads_total: Optional[int] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of `attention_packed` for the output gradient ``do``:
    the plain backward for CPU tensors, the backward kernel (two launches)
    for CUDA tensors, else raise."""
    _check_dropout(dropout_rate, dropout_seed)
    scale = _scale(sm_scale, q.shape[-1] // n_heads)
    if q.device.type == "cpu":
        return attention_packed_bwd_reference(q, k, v, kv_mask, do, n_heads,
                                              causal, scale, dropout_rate,
                                              dropout_seed, head_base,
                                              heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"attention_packed_bwd: no kernel for device "
                         f"{q.device}")
    _check_kernel_args(q, k, v, kv_mask, n_heads)
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"attention_packed_bwd: do {tuple(do.shape)} on "
                         f"{do.device} does not match q {tuple(q.shape)}")
    do = do.to(q.dtype)
    if do.stride(2) != 1:
        do = do.contiguous()
    return _launch_bwd(q, k, v, kv_mask, do, n_heads, causal, scale,
                       dropout_rate, dropout_seed, None, head_base,
                       heads_total)


attention_packed.launches = 0
attention_packed.bwd_launches = 0
attention_packed.launches_by_design = dict.fromkeys(_DESIGNS, 0)
attention_packed.bwd_launches_by_design = dict.fromkeys(_DESIGNS, 0)


# ---------------------------------------------------------------------------
# flash attention: any sequence length
# ---------------------------------------------------------------------------

def flash_row_dot(o: torch.Tensor, do: torch.Tensor,
                  n_heads: int) -> torch.Tensor:
    """di = rowsum(dO . O) per head, fp32 (B, Sq, H): the one torch op of
    the flash backward (an XLA op outside the Pallas calls in
    `m3p_tpu/ops/attention.py:573`)."""
    b, sq, hd = o.shape
    return (o.float() * do.float()).view(b, sq, n_heads,
                                         hd // n_heads).sum(-1)


def attention_flash_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  kv_mask: Optional[torch.Tensor],
                                  o: torch.Tensor, stats: torch.Tensor,
                                  do: torch.Tensor, n_heads: int,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: Optional[int] = None,
                                  head_base: int = 0,
                                  heads_total: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the flash backward (the heads' keep masks as in
    `attention_flash_reference`): (dq, dk, dv) in the layouts and
    dtypes of q, k, v, from the forward's output ``o`` and ``stats``.  The
    math of `_recompute_p_ds` and the dkv/dq kernels
    (`m3p_tpu/ops/attention.py:424-542`), with inv = 1/(1 - rate):

        p  = exp(s - m) / l          dp = dO V^T        di = rowsum(dO . O)
        pd = keep . p . inv          ds = p . (keep . dp . inv - di)
        dv = pd^T dO                 dk = scale ds^T q  dq = scale ds k

    The products take operands rounded to the input type (pd and ds
    included) and sum in fp32.  A masked score gets no gradient (ds = 0),
    as in the vjp of `mha_reference`; query rows go in chunks."""
    _check_dropout(dropout_rate, dropout_seed)
    b, sq, hd = q.shape
    sk = k.shape[1]
    dh = hd // n_heads
    scale = _scale(sm_scale, dh)
    inv = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0.0 else 1.0
    kh, vh = (t.reshape(b, sk, n_heads, dh).float() for t in (k, v))
    di_all = flash_row_dot(o, do, n_heads)
    dq = torch.empty((b, sq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, sk, n_heads, dh), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)

    def rounded(x, dtype):
        return x.to(dtype).float()

    for r0 in range(0, sq, FLASH_ROW_CHUNK):
        r1 = min(sq, r0 + FLASH_ROW_CHUNK)
        n = r1 - r0
        s, valid = _flash_scores(q, k, kv_mask, n_heads, causal, scale, r0,
                                 r1)
        st = stats[:, :, r0:r1]
        p = torch.exp(s - st[..., 0:1]) / st[..., 1:2]
        qh = q[:, r0:r1].reshape(b, n, n_heads, dh).float()
        doh = do[:, r0:r1].reshape(b, n, n_heads, dh).to(v.dtype).float()
        di = di_all[:, r0:r1].permute(0, 2, 1)[..., None]
        dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
        if dropout_rate > 0.0:
            keep = _flash_keep(dropout_seed, dropout_rate, b, n_heads, r0, r1,
                               sk, q.device, head_base, heads_total)
            pd = torch.where(keep, p * inv, 0.0)
            dpd = torch.where(keep, dp * inv, 0.0)
        else:
            pd, dpd = p, dp
        ds = p * (dpd - di)
        if valid is not None:
            ds = ds.masked_fill(~valid, 0.0)
        dv += torch.einsum("bhqk,bqhd->bkhd", rounded(pd, do.dtype), doh)
        dk += torch.einsum("bhqk,bqhd->bkhd", rounded(ds, q.dtype), qh) \
            * scale
        dq[:, r0:r1] = (torch.einsum("bhqk,bkhd->bqhd", rounded(ds, k.dtype),
                                     kh) * scale).reshape(b, n, hd)
    return (dq.to(q.dtype), dk.reshape(b, sk, hd).to(k.dtype),
            dv.reshape(b, sk, hd).to(v.dtype))


def _flash_design(n_heads: int, *tensors: torch.Tensor) -> str:
    """The design of the flash kernels that takes these tensors (q first;
    every (B, S, H*Dh) tensor the kernel reads or writes): "tensor_cores"
    for bf16 with a head dim that is a multiple of 16 up to 128, 16-byte
    aligned data and batch and row strides that are multiples of 8
    elements, else "cuda_cores".  The rule of `tc_fits` in
    `csrc/flash_tile.cuh`, which refuses a tensor-core launch that breaks
    it."""
    dh = tensors[0].shape[-1] // n_heads
    return ("tensor_cores" if _tensor_cores_fit(dh, tensors, 2)
            else "cuda_cores")


_FLASH_FWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
_FLASH_BWD_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 14
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])


def _launch_flash_fwd(q, k, v, kv_mask, n_heads, causal, scale, dropout_rate,
                      dropout_seed, _design=None, head_base=0,
                      heads_total=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the design `_flash_design` names; ``_design``
    "cuda_cores" takes the CUDA-core design instead (for timing the two
    designs on the same tensors; the model path never passes it)."""
    fn = _build.bind("flash_attention", "m3p_flash_attention_fwd",
                     _FLASH_FWD_ARGTYPES)
    b, sq, hd = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((b, n_heads, sq, 2), dtype=torch.float32,
                        device=q.device)
    design = _design or _flash_design(n_heads, q, k, v, out)
    mask = _kernel_mask(kv_mask)
    inv, *philox = _dropout_args(dropout_rate, dropout_seed, n_heads,
                                 head_base, heads_total)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KERNEL_DTYPES[q.dtype], _DESIGNS.index(design),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), stats.data_ptr(), b, sq, sk, n_heads,
                 hd // n_heads, q.stride(0), q.stride(1), k.stride(0),
                 k.stride(1), v.stride(0), v.stride(1), out.stride(0),
                 out.stride(1), float(scale), int(bool(causal)), float(inv),
                 *philox, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({design}) launch "
                           f"failed: CUDA error {err}")
    attention_flash.launches += 1
    attention_flash.launches_by_design[design] += 1
    return out, stats


def _launch_flash_bwd(q, k, v, kv_mask, o, stats, do, n_heads, causal, scale,
                      dropout_rate, dropout_seed, _design=None, head_base=0,
                      heads_total=None) -> Tuple[torch.Tensor, ...]:
    """di = rowsum(dO . O) as one torch op, then two launches of the
    design `_flash_design` names (``_design`` as in `_launch_flash_fwd`):
    dk/dv (one block per key tile), then dq (one block per query tile)."""
    fn = _build.bind("flash_attention_bwd", "m3p_flash_attention_bwd",
                     _FLASH_BWD_ARGTYPES)
    b, sq, hd = q.shape
    sk = k.shape[1]
    di = flash_row_dot(o, do, n_heads).contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    design = _design or _flash_design(n_heads, q, k, v, do, dq, dk, dv)
    mask = _kernel_mask(kv_mask)
    inv, *philox = _dropout_args(dropout_rate, dropout_seed, n_heads,
                                 head_base, heads_total)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(),
            stats.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, sq, sk, n_heads, hd // n_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
            dv.stride(0), dv.stride(1),
            float(scale), int(bool(causal)), float(inv), *philox)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for phase in (0, 1):
            err = fn(_KERNEL_DTYPES[q.dtype], _DESIGNS.index(design),
                     phase, *args, stream)
            if err != 0:
                raise RuntimeError(f"flash_attention backward kernel "
                                   f"({design}, phase {phase}) launch "
                                   f"failed: CUDA error {err}")
            attention_flash.bwd_launches += 1
            attention_flash.bwd_launches_by_design[design] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the `jax.custom_vjp` at
    `m3p_tpu/ops/attention.py:894-921`: saves q, k, v, the key mask, the
    output and the (m, l) row statistics (never p or the mask); the
    backward recomputes p from them and regenerates the mask."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, n_heads, causal, scale, dropout_rate,
                dropout_seed, heads):
        if q.device.type == "cpu":
            out, stats = attention_flash_reference(
                q, k, v, kv_mask, n_heads, causal, scale, dropout_rate,
                dropout_seed, True, *heads)
        else:
            out, stats = _launch_flash_fwd(q, k, v, kv_mask, n_heads, causal,
                                           scale, dropout_rate, dropout_seed,
                                           None, *heads)
        ctx.save_for_backward(q, k, v, kv_mask, out, stats)
        ctx.config = (n_heads, causal, scale, dropout_rate, dropout_seed,
                      *heads)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, stats = ctx.saved_tensors
        grads = attention_flash_bwd(q, k, v, kv_mask, out, stats, do,
                                    *ctx.config)
        return (*grads, None, None, None, None, None, None, None)


def attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor], n_heads: int,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    head_base: int = 0,
                    heads_total: Optional[int] = None) -> torch.Tensor:
    """Flash attention in the packed layout, any lengths: q (B, Sq, H*Dh),
    k/v (B, Sk, H*Dh), kv_mask (B, Sk) True = attend -> (B, Sq, H*Dh);
    differentiable in q, k and v.  ``causal`` aligns the diagonal at the
    end (key j attends to query i when j <= i + Sk - Sq).  ``head_base``
    and ``heads_total`` as in `attention_packed`.

    CPU tensors go through the plain forward and backward; CUDA tensors
    launch `csrc/flash_attention.cu` (replaces the Pallas `_flash_kernel`)
    and `csrc/flash_attention_bwd.cu` (replaces `_flash_bwd_dkv_kernel`
    and `_flash_bwd_dq_kernel`), adding one to ``attention_flash.launches``
    per forward launch and to ``attention_flash.bwd_launches`` per
    backward launch (two per backward), and the same to the design's entry
    of ``attention_flash.launches_by_design`` /
    ``.bwd_launches_by_design`` (`_flash_design`), or raise."""
    _check_dropout(dropout_rate, dropout_seed)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_flash: no kernel for device {q.device}")
    if q.device.type == "cuda":
        _check_kernel_args(q, k, v, kv_mask, n_heads, None, "attention_flash")
    scale = _scale(sm_scale, q.shape[-1] // n_heads)
    return _FlashAttention.apply(q, k, v, kv_mask, n_heads, bool(causal),
                                 scale, float(dropout_rate), dropout_seed,
                                 (head_base, heads_total))


def attention_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor], o: torch.Tensor,
                        stats: torch.Tensor, do: torch.Tensor, n_heads: int,
                        causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        head_base: int = 0,
                        heads_total: Optional[int] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of `attention_flash` from its output ``o`` and row
    statistics ``stats``: the plain backward for CPU tensors, the backward
    kernel (two launches) for CUDA tensors, else raise."""
    _check_dropout(dropout_rate, dropout_seed)
    scale = _scale(sm_scale, q.shape[-1] // n_heads)
    if q.device.type == "cpu":
        return attention_flash_bwd_reference(q, k, v, kv_mask, o, stats, do,
                                             n_heads, causal, scale,
                                             dropout_rate, dropout_seed,
                                             head_base, heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"attention_flash_bwd: no kernel for device "
                         f"{q.device}")
    _check_kernel_args(q, k, v, kv_mask, n_heads, None, "attention_flash")
    b, sq, hd = q.shape
    if do.shape != q.shape or o.shape != q.shape or do.device != q.device:
        raise ValueError(f"attention_flash_bwd: do {tuple(do.shape)} / o "
                         f"{tuple(o.shape)} do not match q {tuple(q.shape)}")
    if stats.shape != (b, n_heads, sq, 2) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError("attention_flash_bwd: stats must be a contiguous "
                         "(B, H, Sq, 2) float32 tensor")
    do = do.to(q.dtype)
    if do.stride(2) != 1:
        do = do.contiguous()
    return _launch_flash_bwd(q, k, v, kv_mask, o, stats, do, n_heads, causal,
                             scale, dropout_rate, dropout_seed, None,
                             head_base, heads_total)


attention_flash.launches = 0
attention_flash.bwd_launches = 0
attention_flash.launches_by_design = dict.fromkeys(_DESIGNS, 0)
attention_flash.bwd_launches_by_design = dict.fromkeys(_DESIGNS, 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: Optional[torch.Tensor], n_heads: int,
              causal: bool = False, sm_scale: Optional[float] = None,
              dropout_rate: float = 0.0,
              dropout_seed: Optional[int] = None, head_base: int = 0,
              heads_total: Optional[int] = None) -> torch.Tensor:
    """The model's attention entry in the packed layout, dispatching by
    length as the JAX module does (`m3p_tpu/model/layers.py:266-308`,
    `m3p_tpu/ops/attention.py:934-988`): the packed kernels when Sq and Sk
    are at most MAX_SEQ, the flash kernels above, attention dropout inside
    either; ``head_base`` / ``heads_total`` as in `attention_packed`."""
    if q.shape[1] <= MAX_SEQ and k.shape[1] <= MAX_SEQ:
        fn = attention_packed
    else:
        fn = attention_flash
    return fn(q, k, v, kv_mask, n_heads, causal, sm_scale, dropout_rate,
              dropout_seed, head_base, heads_total)


# ---------------------------------------------------------------------------
# head-major single-tile attention (#3/#4) and the head-major entry
# ---------------------------------------------------------------------------

# the JAX entry's rate-0 switch to the flash kernels
# (`m3p_tpu/ops/attention.py:931`)
PALLAS_MIN_KV_LEN = 512


def _small_probs(q, k, kv_mask, causal, scale):
    """fp32 softmax weights (B, H, Sq, Sk) of head-major q and k, as the
    Pallas `_small_p` computes them: max, exp, sum, divide."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = _masked_scores(s, kv_mask, causal)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def small_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor] = None,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None,
                              head_base: int = 0,
                              heads_total: Optional[int] = None
                              ) -> torch.Tensor:
    """Plain version of the head-major forward (the heads' keep masks as in
    `attention_flash_reference`): q (B, H, Sq, D), k/v
    (B, H, Sk, D), kv_mask (B, Sk) True = attend -> (B, H, Sq, D) in q's
    dtype.  Step for step `_small_fwd_kernel` (`m3p_tpu/ops/attention.py:
    696-710`): fp32 softmax weights, then with dropout
    ``where(keep, p * (1 / (1 - rate)), 0)`` in fp32 with the Philox mask
    of tile b*H + h (the mask the packed kernels draw for that batch and
    head), then p rounded to v's dtype before P.V, which sums in fp32.  A
    row without any valid key averages v over Sk, as `mha_reference` does
    (the Pallas kernel averages over the key length padded to 128)."""
    _check_dropout(dropout_rate, dropout_seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    p = _small_probs(q, k, kv_mask, causal, _scale(sm_scale, d))
    if dropout_rate > 0.0:
        keep = _keep(dropout_seed, dropout_rate, b, h, sq, sk, q.device,
                     head_base, heads_total)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def small_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  kv_mask: Optional[torch.Tensor],
                                  do: torch.Tensor, causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: Optional[int] = None,
                                  head_base: int = 0,
                                  heads_total: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the head-major backward (the heads' keep masks as
    in `attention_flash_reference`): (dq, dk, dv) in the shapes
    and dtypes of q, k, v.  Step for step `_small_bwd_kernel`
    (`m3p_tpu/ops/attention.py:713-760`), with inv = 1/(1 - rate):

        p    = softmax weights (fp32)     dp   = dO V^T
        p_dv = keep ? p.inv : 0           dp_d = keep ? dp.inv : 0
        di   = rowsum(p_dv . dp)          ds   = p . (dp_d - di)
        dv = p_dv^T dO     dk = scale ds^T q     dq = scale ds k

    each product's operands rounded to the input dtype, summed in fp32.  A
    masked score gets no gradient (ds = 0), as in the vjp of
    `mha_reference`; the Pallas kernel differs on a row without any valid
    key, where it lets dq and dk through the masked scores."""
    _check_dropout(dropout_rate, dropout_seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = _scale(sm_scale, d)
    p = _small_probs(q, k, kv_mask, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(v.dtype).float(), v.float())
    if dropout_rate > 0.0:
        inv = 1.0 / (1.0 - dropout_rate)
        keep = _keep(dropout_seed, dropout_rate, b, h, sq, sk, q.device,
                     head_base, heads_total)
        p_dv = torch.where(keep, p * inv, 0.0)
        dp_d = torch.where(keep, dp * inv, 0.0)
    else:
        p_dv, dp_d = p, dp
    di = (p_dv * dp).sum(-1, keepdim=True)
    ds = p * (dp_d - di)
    valid = _attended(kv_mask, causal, sq, sk, q.device)
    if valid is not None:
        ds = ds.masked_fill(~valid, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_dv.to(do.dtype).float(),
                      do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_small_args(q, k, v, kv_mask, what="small_attention"):
    """Raise on what the head-major kernels do not take."""
    _check_device_and_dtype(q, k, v, kv_mask, what)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: q (B, H, Sq, D) and k/v (B, H, Sk, D) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d > MAX_HEAD_DIM or not (0 < sq <= MAX_SEQ and 0 < sk <= MAX_SEQ):
        raise ValueError(f"{what} kernel: D={d} > {MAX_HEAD_DIM} or Sq={sq}, "
                         f"Sk={sk} outside 1..{MAX_SEQ}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{what} kernel: grid too large")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{what} kernel: the last dimension of q/k/v must "
                         f"be contiguous")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, sk):
        raise ValueError(f"{what}: kv_mask shape {tuple(kv_mask.shape)} != "
                         f"{(b, sk)}")


def _strides(*tensors):
    """The batch, head and row strides of each (B, H, S, D) tensor."""
    return [s for t in tensors for s in t.stride()[:3]]


_SMALL_FWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
_SMALL_BWD_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])


def _launch_small_fwd(q, k, v, kv_mask, causal, scale, dropout_rate,
                      dropout_seed, _design=None, head_base=0,
                      heads_total=None) -> torch.Tensor:
    """One launch of the design `_small_design` names (``_design`` as in
    `_launch_fwd`)."""
    fn = _build.bind("small_attention", "m3p_small_attention_fwd",
                     _SMALL_FWD_ARGTYPES)
    b, h, sq, d = q.shape
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    design = _checked_design(_small_design(q, k, v, out), _design,
                             "small_attention")
    mask = _kernel_mask(kv_mask)
    inv, *philox = _dropout_args(dropout_rate, dropout_seed, h, head_base,
                                 heads_total)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KERNEL_DTYPES[q.dtype], _DESIGNS.index(design),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), b, sq, k.shape[2], h, d,
                 *_strides(q, k, v, out), float(scale), int(bool(causal)),
                 float(inv), *philox, stream)
    if err != 0:
        raise RuntimeError(f"small_attention kernel ({design}) launch "
                           f"failed: CUDA error {err}")
    small_attention.launches += 1
    small_attention.launches_by_design[design] += 1
    return out


def _small_design(*tensors: torch.Tensor) -> str:
    """The design of the head-major forward and backward that takes these
    (B, H, S, D) tensors (q first; every tensor the kernel reads or
    writes): the packed kernels' rule (`_packed_design`) with batch, head
    and row strides multiples of 8 elements."""
    if all(t.shape[2] <= MAX_SEQ for t in tensors) \
            and _tensor_cores_fit(tensors[0].shape[-1], tensors, 3):
        return "tensor_cores"
    return "cuda_cores"


def _launch_small_bwd(q, k, v, kv_mask, do, causal, scale, dropout_rate,
                      dropout_seed, _design=None, head_base=0,
                      heads_total=None) -> Tuple[torch.Tensor, ...]:
    """Two launches of the design `_small_design` names (``_design`` as in
    `_launch_bwd`): dq (and the per-row statistics into a (B, H, Sq, 3)
    fp32 scratch), then dk/dv, which reads them."""
    fn = _build.bind("small_attention", "m3p_small_attention_bwd",
                     _SMALL_BWD_ARGTYPES)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    design = _checked_design(_small_design(q, k, v, do, dq, dk, dv),
                             _design, "small_attention backward")
    mask = _kernel_mask(kv_mask)
    inv, *philox = _dropout_args(dropout_rate, dropout_seed, h, head_base,
                                 heads_total)
    stats, bits = _bwd_scratch(q, sq, sk, h, design, philox[0])
    strides = (ctypes.c_longlong * 21)(*_strides(q, k, v, do, dq, dk, dv))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            None if bits is None else bits.data_ptr(),
            b, sq, sk, h, d, strides, float(scale),
            int(bool(causal)), float(inv), *philox)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for phase in (0, 1):
            err = fn(_KERNEL_DTYPES[q.dtype], _DESIGNS.index(design), phase,
                     *args, stream)
            if err != 0:
                raise RuntimeError(f"small_attention backward kernel "
                                   f"({design}, phase {phase}) launch "
                                   f"failed: CUDA error {err}")
            small_attention.bwd_launches += 1
            small_attention.bwd_launches_by_design[design] += 1
    return dq, dk, dv


class _SmallAttention(torch.autograd.Function):
    """The counterpart of the `jax.custom_vjp` `_attention_pallas_small`
    (`m3p_tpu/ops/attention.py:852-877`): saves q, k, v, the key mask and
    the seed; the backward recomputes p and regenerates the mask."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, dropout_rate,
                dropout_seed, heads):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.config = (causal, scale, dropout_rate, dropout_seed, *heads)
        if q.device.type == "cpu":
            return small_attention_reference(q, k, v, kv_mask, causal, scale,
                                             dropout_rate, dropout_seed,
                                             *heads)
        return _launch_small_fwd(q, k, v, kv_mask, causal, scale,
                                 dropout_rate, dropout_seed, None, *heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask = ctx.saved_tensors
        grads = small_attention_bwd(q, k, v, kv_mask, do, *ctx.config)
        return (*grads, None, None, None, None, None, None)


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None, head_base: int = 0,
                    heads_total: Optional[int] = None) -> torch.Tensor:
    """Head-major single-tile attention: q (B, H, Sq, D), k/v (B, H, Sk,
    D), Sq, Sk <= MAX_SEQ, kv_mask (B, Sk) True = attend -> (B, H, Sq, D);
    differentiable in q, k and v; ``head_base`` / ``heads_total`` as in
    `attention_packed`.  Any strides with a contiguous last
    dimension.  CPU tensors go through the plain forward and backward;
    CUDA tensors launch `csrc/small_attention.cu`, adding one to
    ``small_attention.launches`` per forward launch and to
    ``small_attention.bwd_launches`` per backward launch (two per
    backward), and to the design's entry of
    ``small_attention.launches_by_design`` / ``.bwd_launches_by_design``
    (`_small_design`), or raise.  There is no fallback from one to the
    other, nor from one design to the other."""
    _check_dropout(dropout_rate, dropout_seed)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"small_attention: no kernel for device {q.device}")
    if q.device.type == "cuda":
        _check_small_args(q, k, v, kv_mask)
    scale = _scale(sm_scale, q.shape[-1])
    return _SmallAttention.apply(q, k, v, kv_mask, bool(causal), scale,
                                 float(dropout_rate), dropout_seed,
                                 (head_base, heads_total))


def small_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor], do: torch.Tensor,
                        causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        head_base: int = 0,
                        heads_total: Optional[int] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of `small_attention` for the output gradient ``do``:
    the plain backward for CPU tensors, the backward kernel (two launches)
    for CUDA tensors, else raise."""
    _check_dropout(dropout_rate, dropout_seed)
    scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cpu":
        return small_attention_bwd_reference(q, k, v, kv_mask, do, causal,
                                             scale, dropout_rate,
                                             dropout_seed, head_base,
                                             heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"small_attention_bwd: no kernel for device "
                         f"{q.device}")
    _check_small_args(q, k, v, kv_mask)
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"small_attention_bwd: do {tuple(do.shape)} on "
                         f"{do.device} does not match q {tuple(q.shape)}")
    do = do.to(q.dtype)
    if do.stride(3) != 1:
        do = do.contiguous()
    return _launch_small_bwd(q, k, v, kv_mask, do, causal, scale,
                             dropout_rate, dropout_seed, None, head_base,
                             heads_total)


small_attention.launches = 0
small_attention.bwd_launches = 0
small_attention.launches_by_design = dict.fromkeys(_DESIGNS, 0)
small_attention.bwd_launches_by_design = dict.fromkeys(_DESIGNS, 0)


def _small_fits(q_shape, k_shape) -> bool:
    """One (Sq, Sk) tile per head (`m3p_tpu/ops/attention.py:881`)."""
    return q_shape[2] <= MAX_SEQ and k_shape[2] <= MAX_SEQ


def _flash_bhsd(q, k, v, kv_mask, causal, scale, dropout_rate, dropout_seed):
    """The flash kernels on head-major tensors, through a copy into the
    packed layout and a view of the output back."""
    b, h, sq, d = q.shape

    def packed(t):
        return t.transpose(1, 2).reshape(b, t.shape[2], h * d)

    out = attention_flash(packed(q), packed(k), packed(v), kv_mask, h,
                          causal, scale, dropout_rate, dropout_seed)
    return out.view(b, sq, h, d).transpose(1, 2)


def attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Head-major attention, q (B, H, Sq, D), k/v (B, H, Sk, D) -> (B, H,
    Sq, D), dispatching as the JAX entry `attention` does
    (`m3p_tpu/ops/attention.py:934-988`): with dropout (which needs a seed)
    the single-tile kernels #3/#4 when Sq, Sk <= MAX_SEQ, else the flash
    kernels #5/#6; at rate 0 the flash kernels from a key length of
    PALLAS_MIN_KV_LEN, else `mha_reference` (XLA's attention in JAX, no
    Pallas kernel)."""
    _check_dropout(dropout_rate, dropout_seed)
    scale = _scale(sm_scale, q.shape[-1])
    if dropout_rate > 0.0:
        if _small_fits(q.shape, k.shape):
            return small_attention(q, k, v, kv_mask, causal, scale,
                                   dropout_rate, dropout_seed)
        return _flash_bhsd(q, k, v, kv_mask, causal, scale, dropout_rate,
                           dropout_seed)
    if k.shape[2] >= PALLAS_MIN_KV_LEN:
        return _flash_bhsd(q, k, v, kv_mask, causal, scale, 0.0, None)
    return mha_reference(q, k, v, kv_mask, causal=causal, sm_scale=scale)
