"""Core transformer layers (counterpart of `m3p_tpu/model/layers.py`).

Dtype policy of the JAX package: parameters are stored in fp32; a Dense
casts both its input and its weight to the compute dtype; LayerNorm runs in
fp32 and returns the compute dtype.  Module names mirror the JAX parameter
tree, so `m3p_tpu_torch.checkpoint.params_from_jax` maps it one to one.

Training: every forward takes ``deterministic`` (True = no dropout, as in
JAX) and, when it is False, the `Generators` that draw its randomness.

Decoding: `EncoderBlock` takes a `LayerCache` and `MultiHeadAttention` a
`KVCache`, the head-major keys and values of incremental decoding
(`m3p_tpu/model/layers.py:170-336`, `:603-617`).

Frozen-weight int8 inference (``int8_infer``): `MultiHeadAttention` and
`TransformerFFN` hold optional `ops.quant.Q8Table`s (``q8_qkv``,
``q8_out``, ``q8_lin1``, ``q8_lin2``) that `model.capture_q8` fills; a
module without tables computes its plain GEMMs.

Dynamic int8 training (``ffn_quant`` "int8", "int8_bwd", "int8_all"):
`QuantDense` routes a Dense GEMM through `ops.quant.int8_matmul` or
`int8_matmul_qbwd`; under "int8_all" self-attention projects Q, K and V
as one `int8_matmul_qbwd` GEMM.  `MoEFFN` is the expert-choice
mixture-of-experts FFN of ``moe_experts``.

Parameter sharding (`parallel.sharding.shard_model`): a parameter may hold
this rank's shard only; every module reads its parameters through
`parallel.tensor_parallel.materialize`, which gathers them over the axes
the module does not compute split (all of them, for a module that is not
tensor-parallel).  `MultiHeadAttention` and `TransformerFFN` of the blocks
compute split over ``tensor`` in Megatron's layout (`tensor_parallel`),
and `MoEFFN` over ``expert`` and ``tensor`` (`parallel`).  The int8 modes
compute there too: their quantizers take the whole tensors' scales
(`ops.quant`: each amax over ``tensor`` where that axis splits it), and a
row-parallel int8 product is summed over ``tensor`` before its bias.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from m3p_tpu_torch.ops.activations import gelu_erf
from m3p_tpu_torch.ops.attention import attention, attention_bhsd
from m3p_tpu_torch.ops.dropout import fused_dropout_add
from m3p_tpu_torch.ops.quant import (
    GATE_COUNTS, PREQUANT_MAX_M, Q8Table, gated_linear, int8_matmul,
    int8_matmul_qbwd)
from m3p_tpu_torch.ops.ring_attention import ring_attention
from m3p_tpu_torch.ops.topk import top_k
from m3p_tpu_torch.parallel.data_parallel import batch_mesh
from m3p_tpu_torch.parallel.mesh import Mesh, bound_seq_axis
from m3p_tpu_torch.parallel.tensor_parallel import (
    HeadLayout, columns_to_heads, copy_to, gather_rows, head_layout,
    heads_to_columns, materialize, reduce_from, shard_of, shard_width)

LN_EPS = 1e-12


@dataclass
class Generators:
    """The randomness of a training forward.  ``device`` draws the
    elementwise dropout masks on the model's device; ``host`` draws the
    per-call seeds of the attention and fused residual dropout on the CPU,
    so a seed never costs a host-device sync."""

    device: torch.Generator
    host: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device: Union[str, torch.device],
                  fold: int = 0) -> "Generators":
        """Generators of ``seed`` with ``fold`` (a rank's batch shard, 0 on
        one process) folded in, so no two shards draw the same masks."""
        seed = fold_seed(seed, fold)
        dev = torch.Generator(device=torch.device(device))
        dev.manual_seed(seed)
        host = torch.Generator()
        host.manual_seed(seed + 1)
        return cls(dev, host)

    def fold_in(self, index: int) -> "Generators":
        """New generators for shard ``index`` of a sharded computation: one
        seed drawn from ``host`` (the same draw on every shard) with the
        index folded in, as the JAX sequence-parallel stack folds the shard
        index into its dropout key (`m3p_tpu/parallel/sp.py:84-86`)."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.host))
        return Generators.from_seed(seed, self.device.device, index + 1)

    def attention_seed(self) -> int:
        """A fresh 63-bit seed for one attention call's Philox mask."""
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=self.host))

    def dropout_seed(self) -> int:
        """A fresh 63-bit seed for one fused residual dropout's Philox mask
        (the JAX block draws it from ``make_rng("dropout")``)."""
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=self.host))


def fold_seed(seed: int, fold: int) -> int:
    """``seed`` with ``fold`` folded in: ``seed`` itself at fold 0, else a
    golden-ratio stride away, within torch's 64-bit seed range."""
    return (seed + fold * 0x9E3779B97F4A7C15) % 2 ** 63 if fold else seed


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[Generators]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    divide the kept ones by 1 - rate held in x's dtype (flax's
    ``inputs / keep_prob`` with a weak Python float: bf16(0.9) = 0.8984375
    in bf16), so the kept values equal flax's in fp32 and bf16; identity
    when deterministic.  The mask is drawn on the device of
    ``generator.device``: a CPU generator gives a CUDA forward the masks a
    CPU forward draws."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs generators")
    gen = generator.device
    if gen.device.type == x.device.type:
        keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=gen)
    else:
        keep = torch.empty(x.shape, dtype=x.dtype, device=gen.device
                           ).bernoulli_(1.0 - rate, generator=gen
                                        ).to(x.device)
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype)
    return torch.where(keep.bool(), x / keep_prob, 0.0)


def attention_dropout_args(rate: float, deterministic: bool,
                           generator: Optional[Generators]):
    """(rate, seed) for the attention kernels: a per-call seed drawn on the
    host when dropout is on (`m3p_tpu/model/layers.py:286-292`)."""
    if deterministic or rate == 0.0:
        return 0.0, None
    if generator is None:
        raise ValueError("attention dropout with deterministic=False needs "
                         "generators")
    return rate, generator.attention_seed()


@dataclass
class KVCache:
    """One attention layer's keys and values, head-major (B, H, S, Dh)."""

    k: torch.Tensor
    v: torch.Tensor


@dataclass
class LayerCache:
    """A block's decode cache: ``self_kv`` holds the self-attention keys
    and values of every position so far in a fixed (B, H, S_max, Dh)
    buffer, written in place at each step's position; ``cross_kv`` the
    cross-attention keys and values over the source encoding, projected
    once (None: projected at every step)."""

    self_kv: KVCache
    cross_kv: Optional[KVCache] = None


class Dense(nn.Linear):
    """nn.Linear that computes in ``dtype`` (flax ``nn.Dense(dtype=...)``).

    Under tensor parallelism (set by the tensor-parallel module that owns
    it) ``keep`` is ("tensor",): the weight stays this rank's slice.  The
    Dense is then column-parallel, giving this rank's output columns (its
    caller hands it its input through `copy_to`), unless ``row_parallel``
    (the mesh) is set: it then takes this rank's input columns, and the
    ranks' partial products are summed before the bias."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.keep: tuple = ()
        self.row_parallel: Optional[Mesh] = None

    def weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight in ``dtype`` as computed with (this rank's slice
        under tensor parallelism)."""
        return materialize(self.weight, dtype, self.keep)

    def bias_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The bias in ``dtype`` as computed with."""
        return materialize(self.bias, dtype, self.keep)

    def weights(self):
        """(weight, bias or None) in the compute dtype, as computed with."""
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias_as(dt)
        return self.weight_as(dt), bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weights()
        x = x.to(self.compute_dtype)
        if self.row_parallel is None:
            return F.linear(x, weight, bias)
        y = reduce_from(F.linear(x, weight), self.row_parallel, "tensor")
        return y if bias is None else y + bias


class QuantDense(Dense):
    """A `Dense` whose GEMM runs through the dynamic int8 GEMMs, with the
    Dense's parameters (`m3p_tpu/model/layers.py:339-394`): ``quant_bwd``
    False is `int8_matmul` (straight-through backward), True
    `int8_matmul_qbwd` over the flattened rows (int8 dgrad and wgrad).
    The bias is added after the GEMM in the compute dtype.  Column- and
    row-parallel as a `Dense`: the quantizers of the dimension ``tensor``
    splits (N, or K) take their amax over it, and a row-parallel product's
    partial results, dequantized with those whole scales, are summed over
    ``tensor`` before the bias."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, quant_bwd: bool = False):
        super().__init__(in_features, out_features, dtype)
        self.quant_bwd = quant_bwd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weights()
        xc, kernel = x.to(self.compute_dtype), weight.t()
        row = self.row_parallel
        # the line ``tensor`` splits the product over: K when row-parallel,
        # else N (a kept slice of the output columns)
        line = (None if "tensor" not in self.keep
                else (shard_of(self.weight).mesh, "tensor"))
        k_over = None if row is None else line
        if self.quant_bwd:
            n_over = line if row is None else None
            y = int8_matmul_qbwd(xc.reshape(-1, xc.shape[-1]), kernel,
                                 k_over, n_over)
            y = y.reshape(*xc.shape[:-1], kernel.shape[1])
        else:
            y = int8_matmul(xc, kernel, k_over)
        return reduce_from(y, row, "tensor") + bias


def quant_dense(in_features: int, out_features: int, dtype: torch.dtype,
                quant: str) -> Dense:
    """The Dense of a dynamic int8 mode (`m3p_tpu/model/layers.py:
    416-422`): `QuantDense` under "int8" (straight-through) and "int8_bwd"
    / "int8_all" (int8 backward), a plain `Dense` under any other mode."""
    if quant in ("int8", "int8_bwd", "int8_all"):
        return QuantDense(in_features, out_features, dtype,
                          quant_bwd=quant != "int8")
    return Dense(in_features, out_features, dtype)


class LayerNorm(nn.Module):
    """fp32 LayerNorm (eps 1e-12) returning the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), LN_EPS)
        return y.to(self.compute_dtype)


class MultiHeadAttention(nn.Module):
    """Attention over (B, Sq, D) queries on the no-cache path: self-attention,
    or with ``kv`` (B, Sk, D) cross-attention, whose keys and values are
    projected from ``kv`` (`m3p_tpu/model/layers.py:205-216`).

    Q/K/V stay in the projection layout (B, S, H*Dh) and go straight to
    `ops.attention.attention`, which takes the packed kernels when Sq and
    Sk are at most 512 and the flash kernels above, as the JAX module
    dispatches (`:266-308`); there is no head transpose.  Causal
    self-attention and training-time cross-attention (Sq != Sk) take the
    same kernels.  Attention-weight dropout at ``dropout`` runs inside the
    kernels with a per-call seed.

    With a ``cache`` (incremental decoding, `:198-264`) Q/K/V go head-major
    (B, H, S, Dh) and through `ops.attention.attention_bhsd` at rate 0, as
    the JAX cache branch calls `attention` (`:326-328`): `mha_reference`
    below 512 keys, the flash kernel #5 from 512.  Self-attention writes
    the step's keys and values into the cache at ``pos`` and attends to
    the positions before ``pos + Sq``; cross-attention reads the cached
    source keys and values.  When those have fewer rows than the queries
    (beam search over an unreplicated source), the beams of a row fold
    into its query length, so each row's keys and values are read once,
    not once per beam.

    With int8 tables (`m3p_tpu/model/layers.py:109-196`): self-attention
    without a cache at B * S <= `PREQUANT_MAX_M` rows projects Q, K and V as
    one int8 GEMM over ``q8_qkv`` (the (3D, D) concatenation of the three
    weights); the output projection takes ``q8_out`` at up to
    `PREQUANT_MAX_M` rows, decode steps and cross-attention included.

    ``quant="int8_bwd"`` (`:92-109`, `:184-196`): self-attention without
    a cache projects Q, K and V as one `int8_matmul_qbwd` GEMM over the
    concatenated weights, int8 in the backward too; its three projections
    feed the packed kernels as the plain ones do.  Cross-attention, the
    cache branch and the output projection keep the float GEMMs.

    Inside `parallel.mesh.bind_axes` (the sequence-parallel stack of
    `parallel.sp`), self-attention without a cache runs over a sequence
    sharded along the bound mesh axis, through
    `ops.ring_attention.ring_attention` (`m3p_tpu/model/layers.py:239-246`).
    As there, the ring drops no attention weights, whatever ``dropout``
    says (divergence 11 of ROADMAP.md).

    Tensor parallelism (`tensor_parallel`): this rank holds heads
    ``head_base`` .. ``head_base + n_heads - 1`` of ``heads_total`` in the
    padded layout (`parallel.tensor_parallel.head_layout`: ceil(H / t) a
    rank, the last ranks maybe none), the Q/K/V projections column-parallel
    and the output projection row-parallel, each over its padded columns
    as GSPMD holds them; the attention kernels draw each head's dropout
    mask by its index among all the heads.  Where ``tensor`` divides the
    heads a rank's columns are its heads.  Elsewhere (``layout`` set) every
    branch reshards around the kernels: the projections' columns to this
    rank's heads (`columns_to_heads`) and the context back to columns
    (`heads_to_columns`); a rank without heads launches no kernel, and its
    decode caches hold no head."""

    def __init__(self, n_heads: int, dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 quant: str = "none"):
        super().__init__()
        self.n_heads = n_heads
        self.head_base = 0
        self.heads_total = n_heads
        self.head_dim = dim // n_heads
        self.tp: Optional[Mesh] = None
        self.layout: Optional[HeadLayout] = None
        self.dropout = dropout
        self.quant = quant
        self.q_lin = Dense(dim, dim, dtype)
        self.k_lin = Dense(dim, dim, dtype)
        self.v_lin = Dense(dim, dim, dtype)
        self.out_lin = Dense(dim, dim, dtype)
        self.q8_qkv: Optional[Q8Table] = None
        self.q8_out: Optional[Q8Table] = None

    def tensor_parallel(self, mesh: Mesh) -> None:
        """Compute this rank's heads of ``mesh``'s ``tensor`` axis (the
        parameters already hold their slices, `parallel.sharding`), resharded
        around the kernels where ``tensor`` does not divide the heads."""
        layout = head_layout(mesh, self.heads_total, self.head_dim)
        self.n_heads, self.head_base = layout.n, layout.base
        self.layout = layout if layout.resharded else None
        self.tp = mesh
        for lin in (self.q_lin, self.k_lin, self.v_lin, self.out_lin):
            lin.keep = ("tensor",)
        self.out_lin.row_parallel = mesh

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor],
                causal: bool = False, deterministic: bool = True,
                generator: Optional[Generators] = None, *,
                kv: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                pos: int = 0) -> torch.Tensor:
        """``kv_mask`` (B, Sk) masks the keys: of ``x`` for self-attention,
        of ``kv`` for cross-attention.  With ``cache`` (deterministic
        only): for self-attention the buffer written at ``pos`` (the mask
        is then the cache's own), for cross-attention (``kv`` given) the
        source's projected keys and values, which stand in for ``kv``."""
        x = copy_to(x, self.tp, "tensor")
        if kv is not None:
            kv = copy_to(kv, self.tp, "tensor")
        if cache is not None:
            return self._cached(x, kv_mask, kv is not None, cache, pos)
        bound = bound_seq_axis() if kv is None else None
        if bound is not None:
            return self._ring(x, kv_mask, causal, *bound)
        rate, seed = attention_dropout_args(self.dropout, deterministic,
                                            generator)
        q8 = self.q8_qkv if kv is None else None
        if self.quant == "int8_bwd" and kv is None:
            q, k, v = self._fused_int8_qkv(x)
        elif q8 is not None and x.shape[0] * x.shape[1] <= PREQUANT_MAX_M:
            GATE_COUNTS["int8"] += 1
            bias = torch.cat([lin.bias_as(q8.dtype) for lin in (
                self.q_lin, self.k_lin, self.v_lin)])
            q, k, v = (q8(x) + bias).chunk(3, dim=-1)
        else:
            if q8 is not None:
                GATE_COUNTS["plain"] += 1
            src = x if kv is None else kv
            q, k, v = self.q_lin(x), self.k_lin(src), self.v_lin(src)
        q, k, v = self._to_heads(q, k, v)
        if self.n_heads == 0:
            ctx = q                   # no head on this rank: (B, Sq, 0)
        else:
            ctx = attention(q, k, v, kv_mask, self.n_heads, causal=causal,
                            dropout_rate=rate, dropout_seed=seed,
                            head_base=self.head_base,
                            heads_total=self.heads_total)
        return self._project_out(self._to_columns(ctx))

    def _ring(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor],
              causal: bool, mesh, axis: str) -> torch.Tensor:
        """Self-attention over a sequence sharded along ``mesh``'s
        ``axis``: the local rows' Q, K and V head-major through the ring."""
        if self.quant == "int8_bwd":
            q, k, v = self._fused_int8_qkv(x)
        else:
            q, k, v = self.q_lin(x), self.k_lin(x), self.v_lin(x)
        q, k, v = self._to_heads(q, k, v)
        if self.n_heads == 0:
            # no head on this rank, nor on the ring's other ranks (they
            # share its tensor coordinate)
            return self._project_out(self._to_columns(q))
        ctx = ring_attention(self._split(q), self._split(k), self._split(v),
                             kv_mask, mesh, axis, causal=causal)
        return self._project_out(self._to_columns(self._merge(ctx)))

    def _fused_int8_qkv(self, x: torch.Tensor):
        """Q, K and V of self-attention as one int8 GEMM against the (D, 3D)
        concatenation of the three kernels, the activations quantized once
        (`m3p_tpu/model/layers.py:92-109`); under tensor parallelism this
        rank's heads of each (the backward's per-row scales of g and of
        the kernel then span every rank's columns)."""
        dt = self.q_lin.compute_dtype
        weights = [lin.weights() for lin in (self.q_lin, self.k_lin,
                                              self.v_lin)]
        kernel = torch.cat([w for w, _ in weights]).t()
        bias = torch.cat([b for _, b in weights])
        b, s, d = x.shape
        n_over = None if self.tp is None else (self.tp, "tensor")
        out = int8_matmul_qbwd(x.reshape(-1, d).to(dt), kernel, None, n_over)
        return (out.reshape(b, s, -1) + bias).chunk(3, dim=-1)

    def _to_heads(self, *xs: torch.Tensor) -> tuple:
        """The Q/K/V projections' columns as this rank's heads: as they are
        unless the heads are resharded (`columns_to_heads`, one all-gather
        for all of ``xs``)."""
        if self.layout is None:
            return xs
        return columns_to_heads(self.layout, *xs)

    def _to_columns(self, ctx: torch.Tensor) -> torch.Tensor:
        """The context of this rank's heads (B, S, n_heads * Dh) as the
        output projection's columns (`heads_to_columns` where resharded)."""
        if self.layout is None:
            return ctx
        return heads_to_columns(self.layout, ctx)

    def _project_out(self, ctx: torch.Tensor) -> torch.Tensor:
        """The output projection; int8 over ``q8_out`` at up to
        `PREQUANT_MAX_M` rows."""
        return gated_linear(ctx, self.q8_out, self.out_lin)

    def capture_q8(self, dtype: torch.dtype, self_attention: bool) -> None:
        """Quantize the output projection's weight (and with
        ``self_attention`` the concatenated Q/K/V weights) into int8
        tables: this rank's heads of them under tensor parallelism."""
        if self_attention:
            self.q8_qkv = Q8Table(torch.cat([lin.weight_as(dtype) for lin in (
                self.q_lin, self.k_lin, self.v_lin)]), dtype)
        self.q8_out = Q8Table(self.out_lin.weight_as(dtype), dtype,
                              row_parallel=self.out_lin.row_parallel)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, H*Dh) -> (B, H, S, Dh), a view (H = 0 on a rank without
        heads)."""
        b, s, _ = x.shape
        return x.view(b, s, self.n_heads, self.head_dim).transpose(1, 2)

    @staticmethod
    def _merge(x: torch.Tensor) -> torch.Tensor:
        """(B, H, S, Dh) -> (B, S, H*Dh)."""
        b, h, s, dh = x.shape
        return x.transpose(1, 2).reshape(b, s, h * dh)

    def project_kv(self, src: torch.Tensor) -> KVCache:
        """The keys and values of ``src`` (B, Ss, D), head-major: a
        cross-attention cache (`m3p_tpu/model/transformer.py:405-410`)."""
        src = copy_to(src, self.tp, "tensor")
        k, v = self._to_heads(self.k_lin(src), self.v_lin(src))
        return KVCache(self._split(k), self._split(v))

    def _cached(self, x, kv_mask, cross, cache, pos):
        if cross:
            (q,) = self._to_heads(self.q_lin(x))
            q = self._split(q)
            k, v = cache.k, cache.v
        else:
            q, k, v = (self._split(t) for t in self._to_heads(
                self.q_lin(x), self.k_lin(x), self.v_lin(x)))
            s_max, sq = cache.k.shape[2], q.shape[2]
            if pos + sq > s_max:
                raise ValueError(f"decode position {pos} + {sq} passes the "
                                 f"cache's {s_max} positions")
            cache.k[:, :, pos:pos + sq] = k
            cache.v[:, :, pos:pos + sq] = v
            k, v = cache.k, cache.v
            # the filled part of the cache; the query pad mask does not
            # apply to keys, and the cache mask already ends at the step
            kv_mask = (torch.arange(s_max, device=x.device)
                       < pos + sq).expand(q.shape[0], s_max)
        if self.n_heads == 0:         # no head on this rank: (B, Sq, 0)
            return self._project_out(self._to_columns(self._merge(q)))
        b, _, sq, _ = q.shape
        fold = b // k.shape[0]
        if fold * k.shape[0] != b:
            raise ValueError(f"{b} query rows over {k.shape[0]} cached rows")
        if fold > 1:
            # the K beams of a row share its source keys and values: fold
            # them into the query length (`m3p_tpu/model/layers.py:248-264`)
            bkv, h, dh = k.shape[0], q.shape[1], q.shape[3]
            q = (q.reshape(bkv, fold, h, sq, dh).transpose(1, 2)
                 .reshape(bkv, h, fold * sq, dh))
        ctx = attention_bhsd(q, k, v, kv_mask)
        if fold > 1:
            bkv, h, _, dh = ctx.shape
            ctx = (ctx.reshape(bkv, h, fold, sq, dh).transpose(1, 2)
                   .reshape(b, h, sq, dh))
        return self._project_out(self._to_columns(self._merge(ctx)))


class TransformerFFN(nn.Module):
    """Two-layer MLP with erf-GELU (or ReLU), dropout after the output
    projection unless ``skip_dropout`` (the fused residual path applies it
    with the residual add).  With int8 tables ``q8_lin1`` / ``q8_lin2``
    each GEMM takes int8 at up to `PREQUANT_MAX_M` rows, the plain GEMM
    above (the JAX ``QuantDense`` prequant branch,
    `m3p_tpu/model/layers.py:370-395`).  ``quant`` "int8", "int8_bwd" or
    "int8_all" makes ``lin1`` and ``lin2`` `QuantDense`s (`:397-432`)."""

    def __init__(self, dim: int, hidden_dim: int, gelu_activation: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 quant: str = "none"):
        super().__init__()
        self.lin1 = quant_dense(dim, hidden_dim, dtype, quant)
        self.lin2 = quant_dense(hidden_dim, dim, dtype, quant)
        self.gelu_activation = gelu_activation
        self.dropout = dropout
        self.tp: Optional[Mesh] = None
        self.q8_lin1: Optional[Q8Table] = None
        self.q8_lin2: Optional[Q8Table] = None

    def tensor_parallel(self, mesh: Mesh) -> None:
        """Compute this rank's hidden columns of ``mesh``'s ``tensor`` axis:
        ``lin1`` column-parallel, ``lin2`` row-parallel."""
        self.tp = mesh
        self.lin1.keep = self.lin2.keep = ("tensor",)
        self.lin2.row_parallel = mesh

    def capture_q8(self, dtype: torch.dtype) -> None:
        """Quantize both weights into int8 tables (this rank's hidden
        columns of each under tensor parallelism)."""
        self.q8_lin1 = Q8Table(self.lin1.weight_as(dtype), dtype)
        self.q8_lin2 = Q8Table(self.lin2.weight_as(dtype), dtype,
                               row_parallel=self.lin2.row_parallel)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[Generators] = None,
                skip_dropout: bool = False) -> torch.Tensor:
        x = copy_to(x, self.tp, "tensor")
        h = gated_linear(x, self.q8_lin1, self.lin1)
        h = gelu_erf(h) if self.gelu_activation else F.relu(h)
        h = gated_linear(h, self.q8_lin2, self.lin2)
        if skip_dropout:
            return h
        return dropout(h, self.dropout, deterministic, generator)


class MoEFFN(nn.Module):
    """Mixture-of-experts FFN with expert-choice routing
    (`m3p_tpu/model/layers.py:435-519`): an fp32 softmax over the experts'
    router logits; each expert takes its top C = min(T, max(1, int(cf * T
    / E))) of the T tokens by affinity (the stable `ops.topk.top_k`, in
    `lax.top_k`'s order of ties), runs them through its GELU (or ReLU)
    MLP, weights the outputs by their affinities and adds them back to
    their tokens; a token no expert took outputs zero.  Dropout after, as
    the dense FFN, unless ``skip_dropout``.

    The parameters are the JAX module's raw arrays in its layouts, none
    transposed: ``router`` (D, E) fp32, ``w1`` (E, D, H), ``b1`` (E, H),
    ``w2`` (E, H, D), ``b2`` (E, D).  The expert GEMMs are batched
    products (`torch.bmm`), the return an `index_add_`.

    The tokens are those of the global batch, as the JAX step's GSPMD sees
    them: inside a train step over several batch shards
    (`parallel.data_parallel.batch_reduction`) each rank gathers every
    shard's tokens (B rows of the ("data", "fsdp") line, each within the
    sequence positions it holds), each expert takes its top C of all of
    them, with C from the global count, and the rank keeps its own rows of
    the combined output.  Under `parallel` each rank of the ``expert`` axis
    runs its own experts (the router is whole on every rank) and the
    combine sums over the axis; ``mlp`` inside the experts is split over
    ``tensor`` (``w1`` column-, ``w2`` row-parallel).  Experts that do not
    divide by ``expert`` are held padded, as GSPMD holds them: a rank holds
    ceil(E / n) experts' slices, of which ``n_local`` are real (the last
    ranks may hold none and then add zeros)."""

    def __init__(self, dim: int, hidden_dim: int, n_experts: int,
                 capacity_factor: float = 2.0, gelu_activation: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        e = n_experts
        self.n_experts = e
        self.capacity_factor = capacity_factor
        self.gelu_activation = gelu_activation
        self.compute_dtype = dtype
        self.dropout = dropout
        self.router = nn.Parameter(torch.empty(dim, e))
        self.w1 = nn.Parameter(torch.empty(e, dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(e, hidden_dim))
        self.w2 = nn.Parameter(torch.empty(e, hidden_dim, dim))
        self.b2 = nn.Parameter(torch.zeros(e, dim))
        self.mesh: Optional[Mesh] = None
        self.expert_lo, self.n_local = 0, e

    def parallel(self, mesh: Mesh) -> None:
        """Run this rank's experts of ``mesh``'s ``expert`` axis, their
        hidden columns split over ``tensor`` (the parameters already hold
        their slices, `parallel.sharding`, padded where the experts do not
        divide)."""
        per = shard_width(self.n_experts, mesh.shape["expert"])
        self.expert_lo = min(mesh.index("expert") * per, self.n_experts)
        self.n_local = min(per, self.n_experts - self.expert_lo)
        self.mesh = mesh

    def capacity(self, tokens: int) -> int:
        """C, the tokens each expert takes out of ``tokens``."""
        return min(tokens, max(1, int(self.capacity_factor * tokens
                                      / self.n_experts)))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[Generators] = None,
                skip_dropout: bool = False) -> torch.Tensor:
        b, s, d = x.shape
        dt = self.compute_dtype
        mesh = self.mesh
        xt = x.reshape(b * s, d)
        batch = batch_mesh()
        lo = 0
        if batch is not None:
            # every batch shard's tokens: the global batch's expert choice
            lo = batch.index(("data", "fsdp")) * b * s
            xt = gather_rows(xt, batch, ("data", "fsdp"))
        xt = copy_to(xt, mesh, "expert")
        router = materialize(self.router, torch.float32, sum_over=("expert",))
        affinity = torch.softmax(xt.float() @ router, dim=-1)
        gates, idx = top_k(affinity.t(), self.capacity(xt.shape[0]))  # (E, C)
        # this rank's real experts: none on a rank that holds padding alone,
        # which then adds zeros through the same (empty) graph, so its
        # backward takes part in the router's and the weights' reductions
        mine = slice(self.expert_lo, self.expert_lo + self.n_local)
        gates, idx = gates[mine], idx[mine]
        keep = ("expert", "tensor")
        w1, b1, w2, b2 = (materialize(p, dt, keep)[:self.n_local] for p in (
            self.w1, self.b1, self.w2, self.b2))
        xe = copy_to(xt[idx].to(dt), mesh, "tensor")           # (E, C, D)
        h = torch.bmm(xe, w1) + b1[:, None]
        h = gelu_erf(h) if self.gelu_activation else F.relu(h)
        ye = reduce_from(torch.bmm(h, w2), mesh, "tensor") + b2[:, None]
        ye = ye * gates[..., None].to(dt)
        y = xt.new_zeros(xt.shape, dtype=dt).index_add(
            0, idx.reshape(-1), ye.reshape(-1, d))
        y = reduce_from(y[lo:lo + b * s], mesh, "expert").reshape(b, s, d)
        if skip_dropout:
            return y
        return dropout(y, self.dropout, deterministic, generator)


class EncoderBlock(nn.Module):
    """Post-LN block: x = LN1(x + drop(attn(x))); with a source encoding
    x = LN15(x + drop(encoder_attn(x, src_enc))); x = LN2(x + ffn(x)), the
    FFN applying its own output dropout; x *= pad
    (`m3p_tpu/model/layers.py:570-627`).  Causal self-attention with
    cross-attention over ``src_enc`` is the decoder block; without
    ``src_enc`` the block is the encoder's.

    With ``use_fused_dropout``, in a training forward at ``dropout`` > 0,
    every residual (two, three with ``src_enc``) goes through
    `ops.dropout.fused_dropout_add` (kernels #7 and #8 on CUDA, the plain
    version on the CPU) with its own seed drawn on the host, and the FFN
    skips its own dropout.  The JAX block takes that path on a TPU backend
    only (`:590-601`).

    Every block holds ``encoder_attn``/``ln15``, as in the JAX tree; they
    run when ``src_enc`` is given.

    With a `LayerCache` the block takes one decode step (deterministic,
    `:603-617`): the self cache goes to ``attn`` (written at ``pos``), the
    cross cache to ``encoder_attn`` (without one it projects ``src_enc``
    at every step).

    ``ffn_quant`` goes to the FFN; under "int8_all" both attentions take
    ``quant="int8_bwd"`` (`:543-549`).  ``moe_experts`` > 0 puts a
    `MoEFFN` (``moe_ffn``) in place of the dense ``ffn`` (`:555-562`); such
    a block refuses a causal call, since expert-choice routing picks
    tokens over the whole sequence."""

    def __init__(self, n_heads: int, dim: int, ffn_dim: int,
                 gelu_activation: bool = True,
                 has_cross_attention: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 use_fused_dropout: bool = False, ffn_quant: str = "none",
                 moe_experts: int = 0, moe_capacity_factor: float = 2.0):
        super().__init__()
        self.dropout = dropout
        self.use_fused_dropout = use_fused_dropout
        self.has_cross_attention = has_cross_attention
        attn_quant = "int8_bwd" if ffn_quant == "int8_all" else "none"
        self.attn = MultiHeadAttention(n_heads, dim, dtype, attention_dropout,
                                       attn_quant)
        self.ln1 = LayerNorm(dim, dtype)
        if has_cross_attention:
            self.encoder_attn = MultiHeadAttention(
                n_heads, dim, dtype, attention_dropout, attn_quant)
            self.ln15 = LayerNorm(dim, dtype)
        if moe_experts > 0:
            self.moe_ffn = MoEFFN(dim, ffn_dim, moe_experts,
                                  moe_capacity_factor, gelu_activation,
                                  dtype, dropout)
            self.ffn = None
        else:
            self.ffn = TransformerFFN(dim, ffn_dim, gelu_activation, dtype,
                                      dropout, ffn_quant)
            self.moe_ffn = None
        self.ln2 = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                causal: bool = False, deterministic: bool = True,
                generator: Optional[Generators] = None, *,
                src_enc: Optional[torch.Tensor] = None,
                src_mask: Optional[torch.Tensor] = None,
                cache: Optional[LayerCache] = None,
                pos: int = 0) -> torch.Tensor:
        """``src_enc`` (B, Ss, D) with its mask ``src_mask`` (B, Ss) adds the
        cross-attention step; ``cache`` and ``pos`` make it a decode step
        over the positions before ``pos`` + S."""
        if cache is not None and not deterministic:
            raise ValueError("a decode step with a cache is deterministic")
        if causal and self.moe_ffn is not None:
            raise ValueError("MoE (expert-choice) blocks do not support "
                             "causal decoding")
        ffn = self.ffn if self.moe_ffn is None else self.moe_ffn
        fused = (self.use_fused_dropout and not deterministic
                 and self.dropout > 0)
        if fused and generator is None:
            raise ValueError("fused dropout with deterministic=False needs "
                             "generators")

        def residual(branch, res):
            if fused:
                return fused_dropout_add(branch, res,
                                         generator.dropout_seed(),
                                         self.dropout)
            return res + dropout(branch, self.dropout, deterministic,
                                 generator)

        self_kv = cache.self_kv if cache is not None else None
        cross_kv = cache.cross_kv if cache is not None else None
        x = self.ln1(residual(
            self.attn(x, pad_mask, causal, deterministic, generator,
                      cache=self_kv, pos=pos), x))
        if self.has_cross_attention and src_enc is not None:
            x = self.ln15(residual(
                self.encoder_attn(x, src_mask, False, deterministic,
                                  generator, kv=src_enc, cache=cross_kv),
                x))
        if fused:
            h = ffn(x, deterministic, generator, skip_dropout=True)
            x = self.ln2(residual(h, x))
        else:
            # the FFN applied its own output dropout (the reference layout)
            x = self.ln2(x + ffn(x, deterministic, generator))
        return x * pad_mask[..., None].to(x.dtype)
