"""The operators of parameter sharding: FSDP's gathers, Megatron's tensor
parallelism, the vocabulary-parallel embedding and cross-entropy.

The JAX package shards its parameters by logical axes and lets GSPMD insert
the collectives (`m3p_tpu/parallel/sharding.py`).  Here each rank holds its
shard of a parameter as a plain tensor (`parallel.sharding.shard_model`
slices it and records a `ShardSpec` on it as ``param.shard``), and the
model calls these operators, each a `torch.autograd.Function` over the
collectives of `parallel.mesh`:

* `materialize` -- a parameter as the model computes with it: its shard
  cast to the compute dtype (elementwise, so a bf16 gather is exact and
  half the bytes), all-gathered over each mesh axis that splits it and that
  the caller does not keep split.  Over ``fsdp`` (the ranks hold other
  rows of the batch) the backward reduce-scatters the gradient, summed in
  fp32 and handed back in the parameter's dtype; over ``tensor`` or
  ``expert`` the ranks compute alike on the same rows, so the backward
  takes this rank's slice of the gradient, unless the caller names the
  axis in ``sum_over`` (each rank then holds a part of the gradient).
* `copy_to` (identity forward, all-reduce backward) and `reduce_from`
  (all-reduce forward, identity backward): Megatron's f and g around a
  column- and a row-parallel product.
* `gather_rows` -- rows of every rank of a line, concatenated (MoE's global
  tokens); the backward is this rank's rows of the gradient.
* `columns_to_heads` / `heads_to_columns` -- the reshard of attention
  whose heads do not divide by ``tensor`` (`HeadLayout`): the Q/K/V
  projections give a rank its padded columns, the kernels take whole
  heads, and the output projection takes the columns again.  Each is the
  other's backward.
* `vocab_parallel_ce` / `vocab_parallel_argmax` -- the cross-entropy and
  the argmax over logits whose vocabulary is split over ``tensor``: a
  distributed logsumexp and the target's logit from the rank that owns
  it; the full logits are never gathered.  `vocab_parallel_log_softmax`
  normalizes such logits (the adaptive softmax's head and tails), and
  `gather_vocab` assembles them whole.

Uneven splits are held as GSPMD holds them: a dimension of n entries over
k ranks is cut into shards of ceil(n / k), rank i holding entries i *
ceil(n / k) onward, and the whole padded with zeros at its end to k
shards, so the last shards hold the padding (`shard_width`).
`local_slice` pads and slices, `gather_whole` and `materialize` trim the
padding off what they assemble, and `materialize`'s backward gives the
padding a zero gradient, so it stays zero under any optimizer.  A module
that computes on a kept shard sees its padding: the vocabulary's (a
`VocabShard` names the real words, and the heads cut their logits to
them before any logsumexp, argmax or top-k), or the FFN's hidden columns,
whose zero weights and biases give zero activations (GELU and ReLU of 0
are 0) and add nothing to the row-parallel sum.

Heads follow the same layout, a head being the unit: of H heads over t
ranks, rank r holds the heads from r * ceil(H / t) up to min(H, (r + 1) *
ceil(H / t)), so the last ranks may hold none (12 heads over tensor 8: 2,
2, 2, 2, 2, 2, 0, 0).  Where t divides H a rank's columns are its heads
and nothing is resharded; elsewhere a rank's columns and its heads
differ, and `columns_to_heads` all-gathers the columns of every rank and
keeps this rank's heads, `heads_to_columns` places this rank's heads into
zeros of the whole width and reduce-scatters them (each column has one
non-zero part, so the sum is exact).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from m3p_tpu_torch.parallel import mesh as M
from m3p_tpu_torch.parallel.mesh import Mesh

@dataclass(frozen=True)
class ShardSpec:
    """How a parameter is split: ``axes[d]`` is the mesh axis that splits
    dimension d of the whole parameter (None: not split), ``shape`` the
    whole parameter's shape."""

    mesh: Mesh
    axes: Tuple[Optional[str], ...]
    shape: Tuple[int, ...]

    def split(self) -> Tuple[Tuple[int, str], ...]:
        """(dimension, axis) of each split dimension."""
        return tuple((d, a) for d, a in enumerate(self.axes)
                     if a is not None)


def shard_of(p: torch.Tensor) -> Optional[ShardSpec]:
    return getattr(p, "shard", None)


def shard_width(n: int, k: int) -> int:
    """The entries of each shard of a dimension of ``n`` split over ``k``
    ranks: ceil(n / k), the last shards padded (module docstring)."""
    return -(-n // k)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` padded with zeros at the end of ``dim`` to ``size``."""
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class _GatherDim(torch.autograd.Function):
    """``x`` cast to ``dtype`` and all-gathered along ``dim`` over
    ``axis``, cut to the whole ``size``; the backward pads the gradient
    back and reduce-scatters it (``reduce``) in fp32 or takes this rank's
    slice, in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, dtype, reduce, size):
        ctx.mesh, ctx.axis, ctx.dim, ctx.reduce = mesh, axis, dim, reduce
        ctx.in_dtype, ctx.width = x.dtype, x.shape[dim]
        parts = M.all_gather_stack(x.detach().to(dtype).contiguous(), mesh,
                                   axis)
        return torch.cat(parts.unbind(0), dim=dim).narrow(dim, 0, size)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim, w = ctx.mesh, ctx.axis, ctx.dim, ctx.width
        grad = _pad_to(grad, dim, w * mesh.shape[axis])
        if not ctx.reduce:
            i = mesh.index(axis)
            out = grad.narrow(dim, i * w, w)
        else:
            parts = torch.stack(grad.float().split(w, dim=dim))
            out = M.reduce_scatter_sum(parts, mesh, axis)
        return out.to(ctx.in_dtype), None, None, None, None, None, None


def materialize(p: torch.Tensor, dtype: torch.dtype,
                keep: Sequence[str] = (),
                sum_over: Sequence[str] = ()) -> torch.Tensor:
    """``p`` in ``dtype`` as the model computes with it: gathered over every
    axis of its `ShardSpec` but those in ``keep`` (module docstring).  The
    ``fsdp`` gather comes first, so its backward sums in fp32 and hands the
    parameter's dtype back.  A parameter without a spec is ``p.to(dtype)``."""
    spec = shard_of(p)
    if spec is None:
        return p.to(dtype)
    x = p
    order = sorted(spec.split(), key=lambda da: da[1] != "fsdp")
    for dim, axis in order:
        if axis in keep:
            continue
        reduce = axis == "fsdp" or axis in sum_over
        x = _GatherDim.apply(x, spec.mesh, axis, dim, dtype, reduce,
                             spec.shape[dim])
    return x.to(dtype)


@torch.no_grad()
def gather_whole(t: torch.Tensor, spec: Optional[ShardSpec]) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's shard under ``spec``
    (a parameter, its gradient or its optimizer state), in ``t``'s dtype."""
    if spec is None:
        return t
    for dim, axis in spec.split():
        t = torch.cat(M.all_gather_stack(t.contiguous(), spec.mesh,
                                         axis).unbind(0), dim=dim)
        t = t.narrow(dim, 0, spec.shape[dim])
    return t.contiguous()


def shard_padding(t: torch.Tensor, spec: ShardSpec) -> list:
    """The entries of this rank's shard ``t`` (a parameter, its gradient or
    its optimizer state) under ``spec`` that lie beyond the whole tensor's
    end: an uneven split's padding (module docstring), one view for each
    split dimension, empty where that dimension has none."""
    views = []
    for d, axis in spec.split():
        w = t.shape[d]
        real = min(max(spec.shape[d] - spec.mesh.index(axis) * w, 0), w)
        views.append(t.narrow(d, real, w - real))
    return views


def local_slice(t: torch.Tensor, spec: Optional[ShardSpec]) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec``: along a
    dimension that does not divide, ceil(n / k) entries, the padding zeros
    (module docstring)."""
    if spec is None:
        return t
    for dim, axis in spec.split():
        n = spec.mesh.shape[axis]
        w = shard_width(t.shape[dim], n)
        t = _pad_to(t, dim, w * n).narrow(dim, spec.mesh.index(axis) * w, w)
    return t.contiguous()


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (M.all_reduce_sum(grad, ctx.mesh, ctx.mesh.group(ctx.axes)),
                None, None)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return M.all_reduce_sum(x, mesh, mesh.group(axes))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient summed over ``axes`` (the
    input of a column-parallel product, replicated over the axis)."""
    if mesh is None or mesh.group(axes) is None:
        return x
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh], axes
                ) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``axes`` (the partial output of a
    row-parallel product); the gradient as it is."""
    if mesh is None or mesh.group(axes) is None:
        return x
    return _ReduceFrom.apply(x, mesh, axes)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.i, ctx.w, ctx.dim = mesh.index(axes), x.shape[dim], dim
        return M.all_gather_cat(x.contiguous(), mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.i * ctx.w, ctx.w), None, None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
                ) -> torch.Tensor:
    """``x`` of every rank of the line over ``axes``, concatenated along
    ``dim`` in coordinate order; the gradient of this rank's part only (the
    caller's loss reads its own rows alone, so the other ranks' parts of the
    gradient are zeros)."""
    if mesh.group(axes) is None:
        return x
    return _GatherRows.apply(x, mesh, axes, dim)


# ---------------------------------------------------------------------------
# heads over ``tensor``
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HeadLayout:
    """This rank's heads ``base`` .. ``base + n - 1`` of ``total`` heads of
    ``head_dim`` split over ``mesh``'s ``tensor`` axis (module docstring),
    and the ``width`` of the padded column shard each rank's projections
    give it."""

    mesh: Mesh
    total: int
    head_dim: int
    base: int
    n: int
    width: int

    @property
    def resharded(self) -> bool:
        """Whether a rank's columns differ from its heads (``tensor`` does
        not divide the heads)."""
        return self.total % self.mesh.shape["tensor"] != 0

    @property
    def columns(self) -> slice:
        """This rank's heads' columns in the whole (..., H * head_dim)."""
        return slice(self.base * self.head_dim,
                     (self.base + self.n) * self.head_dim)


# the bytes the heads reshard handled on this rank (its share of
# `parallel.mesh.COLLECTIVE_BYTES`): the whole (rows, t * width) each
# all-gather assembles and each reduce-scatter sums
RESHARD_BYTES = {"all_gather": 0, "reduce_scatter": 0}


def head_layout(mesh: Mesh, total: int, head_dim: int) -> HeadLayout:
    """This rank's heads of ``total`` heads over ``mesh``'s ``tensor``."""
    k = mesh.shape["tensor"]
    per = shard_width(total, k)
    base = min(mesh.index("tensor") * per, total)
    return HeadLayout(mesh, total, head_dim, base, min(per, total - base),
                      shard_width(total * head_dim, k))


def _rows(xs, width: int) -> torch.Tensor:
    """The tensors ``xs`` (..., width) as one (rows, width) block (a width
    of 0 too: a rank without heads)."""
    return torch.cat([x.reshape(x.shape[:-1].numel(), width) for x in xs])


def _unrows(block: torch.Tensor, shapes) -> tuple:
    """`_rows` undone: ``block``'s rows split back to ``shapes``' leading
    dimensions, each with ``block``'s last dimension."""
    sizes = [s[:-1].numel() for s in shapes]
    return tuple(part.reshape(*s[:-1], block.shape[-1])
                 for part, s in zip(block.split(sizes), shapes))


def _gather_heads(block: torch.Tensor, layout: HeadLayout) -> torch.Tensor:
    """(R, width) of this rank's columns -> (R, n * head_dim) of its heads:
    every rank's columns gathered, this rank's heads kept."""
    parts = M.all_gather_stack(block.contiguous(), layout.mesh, "tensor")
    RESHARD_BYTES["all_gather"] += parts.numel() * parts.element_size()
    whole = parts.transpose(0, 1).reshape(block.shape[0], -1)
    return whole[:, layout.columns]


def _scatter_heads(block: torch.Tensor, layout: HeadLayout) -> torch.Tensor:
    """(R, n * head_dim) of this rank's heads -> (R, width) of its columns:
    the heads placed into zeros of every rank's columns and reduce-scattered
    (one non-zero part a column: exact)."""
    k = layout.mesh.shape["tensor"]
    whole = block.new_zeros(block.shape[0], k * layout.width)
    whole[:, layout.columns] = block
    parts = whole.view(block.shape[0], k, layout.width).transpose(0, 1)
    RESHARD_BYTES["reduce_scatter"] += whole.numel() * whole.element_size()
    return M.reduce_scatter_sum(parts, layout.mesh, "tensor")


class _ColumnsToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layout, *xs):
        ctx.layout, ctx.shapes = layout, [x.shape for x in xs]
        heads = _gather_heads(_rows(xs, layout.width), layout)
        return _unrows(heads, ctx.shapes)

    @staticmethod
    def backward(ctx, *grads):
        layout = ctx.layout
        block = _rows(grads, layout.n * layout.head_dim)
        return (None,) + _unrows(_scatter_heads(block, layout), ctx.shapes)


class _HeadsToColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layout, x):
        ctx.layout, ctx.shape = layout, x.shape
        block = _rows([x], layout.n * layout.head_dim)
        return _scatter_heads(block, layout).reshape(*x.shape[:-1],
                                                     layout.width)

    @staticmethod
    def backward(ctx, grad):
        layout = ctx.layout
        block = _gather_heads(grad.reshape(-1, layout.width), layout)
        return None, block.reshape(ctx.shape)


def columns_to_heads(layout: HeadLayout, *xs: torch.Tensor) -> tuple:
    """Each of ``xs`` (..., width), this rank's padded columns of the Q, K
    or V projection, as (..., n * head_dim), this rank's heads: one
    all-gather over ``tensor`` for all of them.  The backward is
    `heads_to_columns`'s forward."""
    return _ColumnsToHeads.apply(layout, *xs)


def heads_to_columns(layout: HeadLayout, x: torch.Tensor) -> torch.Tensor:
    """The attention output of this rank's heads (..., n * head_dim) as its
    padded columns (..., width), the output projection's input: one
    reduce-scatter over ``tensor``.  The backward is `columns_to_heads`'s
    forward."""
    return _HeadsToColumns.apply(layout, x)


# ---------------------------------------------------------------------------
# the vocabulary split over ``tensor``
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VocabShard:
    """This rank's words ``lo`` .. ``lo + n - 1`` of a vocabulary of
    ``total`` words split over ``mesh``'s ``tensor`` axis, held in a shard
    of ``width`` rows (``n`` plus the padding of an uneven split)."""

    mesh: Mesh
    lo: int
    n: int
    width: int
    total: int

    def local(self, ids: torch.Tensor):
        """(ids - lo clamped into range, whether each id is this rank's)."""
        local = ids.long() - self.lo
        inside = (local >= 0) & (local < self.n)
        return local.clamp(0, self.n - 1), inside


def vocab_shard(mesh: Mesh, total: int) -> VocabShard:
    """This rank's words of a ``total``-word dimension split over
    ``tensor`` in the padded layout; raises where a rank would hold
    padding alone."""
    k = mesh.shape["tensor"]
    width = shard_width(total, k)
    lo = mesh.index("tensor") * width
    if lo >= total:
        raise ValueError(f"{total} words over tensor={k} leave rank "
                         f"{mesh.index('tensor')} of the axis no word")
    return VocabShard(mesh, lo, min(width, total - lo), width, total)


def gather_vocab(x: torch.Tensor, vocab: Optional[VocabShard]
                 ) -> torch.Tensor:
    """Logits (..., n) of this rank's words, whole (..., total) on every
    rank: padded to the shard's width, gathered, the padding (the whole's
    end) cut off; the backward is this rank's slice."""
    if vocab is None:
        return x
    x = F.pad(x, (0, vocab.width - vocab.n))
    x = _GatherRows.apply(x, vocab.mesh, "tensor", x.dim() - 1)
    return x[..., :vocab.total]


def vocab_parallel_lookup(ids: torch.Tensor, table: torch.Tensor,
                          vocab: VocabShard) -> torch.Tensor:
    """Rows ``ids`` of a table whose rows are split over ``tensor``
    (``table`` this rank's rows): each rank looks up its own words, zeros
    the others, and the ranks' parts are summed."""
    local, inside = vocab.local(ids)
    rows = torch.nn.functional.embedding(local, table)
    rows = rows * inside[..., None].to(rows.dtype)
    return reduce_from(rows, vocab.mesh, "tensor")


def _vocab_logsumexp(x: torch.Tensor, vocab: VocabShard):
    """The parts of the logsumexp of fp32 logits ``x`` (..., n) over every
    rank's columns: (m, e, total), the max m (..., 1) and the sum of e =
    exp(x - m) (..., 1) both taken over ``tensor``."""
    mesh, group = vocab.mesh, vocab.mesh.group("tensor")
    m = M.all_reduce_max(x.amax(dim=-1, keepdim=True), mesh, group)
    e = torch.exp(x - m)
    total = M.all_reduce_sum(e.sum(dim=-1, keepdim=True), mesh, group)
    return m, e, total


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, vocab):
        x = logits.float()
        m, e, total = _vocab_logsumexp(x, vocab)
        local, inside = vocab.local(labels)
        mine = x.gather(1, local[:, None])[:, 0] * inside
        target = M.all_reduce_sum(mine, vocab.mesh,
                                  vocab.mesh.group("tensor"))
        ctx.save_for_backward(e, total, local, inside)
        ctx.dtype = logits.dtype
        return (torch.log(total) + m)[:, 0] - target

    @staticmethod
    def backward(ctx, grad):
        e, total, local, inside = ctx.saved_tensors
        p = e / total
        p.scatter_add_(1, local[:, None], -inside.float()[:, None])
        return (p * grad[:, None]).to(ctx.dtype), None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      vocab: Optional[VocabShard]) -> torch.Tensor:
    """Per-row cross-entropy in fp32 of logits (N, V) against labels (N,):
    with ``vocab`` the logits are this rank's (N, V / tensor) columns, and
    the logsumexp and the target's logit are taken over the ranks."""
    if vocab is None:
        return torch.nn.functional.cross_entropy(
            logits.float(), labels.long(), reduction="none")
    return _VocabCE.apply(logits, labels.long(), vocab)


class _VocabLogSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, vocab):
        x = logits.float()
        m, e, total = _vocab_logsumexp(x, vocab)
        ctx.save_for_backward(e / total)
        ctx.vocab, ctx.dtype = vocab, logits.dtype
        return x - m - torch.log(total)

    @staticmethod
    def backward(ctx, grad):
        (p,) = ctx.saved_tensors
        mesh = ctx.vocab.mesh
        gsum = M.all_reduce_sum(grad.sum(dim=-1, keepdim=True), mesh,
                                mesh.group("tensor"))
        return (grad - p * gsum).to(ctx.dtype), None


def vocab_parallel_log_softmax(logits: torch.Tensor,
                               vocab: Optional[VocabShard]) -> torch.Tensor:
    """``log_softmax`` in fp32 over the last dimension; with ``vocab`` the
    logits are this rank's columns, and the max and the sum of
    exponentials are taken over ``tensor``."""
    if vocab is None:
        return torch.log_softmax(logits.float(), dim=-1)
    return _VocabLogSoftmax.apply(logits, vocab)


@torch.no_grad()
def vocab_parallel_argmax(logits: torch.Tensor,
                          vocab: Optional[VocabShard]) -> torch.Tensor:
    """The argmax over the last dimension; with ``vocab`` over every rank's
    columns, the lowest index among equal maxima, as ``torch.argmax``."""
    if vocab is None:
        return logits.argmax(dim=-1)
    idx = logits.argmax(dim=-1)
    values = logits.gather(-1, idx[..., None])[..., 0]
    mesh = vocab.mesh
    all_v = M.all_gather_stack(values.contiguous(), mesh, "tensor")
    all_i = M.all_gather_stack((idx + vocab.lo).contiguous(), mesh, "tensor")
    best = all_v.argmax(dim=0)
    return all_i.gather(0, best[None])[0]
