"""Data parallelism over the mesh's batch shards: the global-batch loss of
the JAX package, computed shard by shard.

The JAX package computes every loss over the global batch, so a mean over
masked slots divides by the global count.  Here each rank holds its shard
of the batch, and the convention is: every loss and metric a rank returns
is scaled so that its mean over the batch shards is the global value.

* A mean over rows (cross-entropy over the batch) needs nothing when the
  shards are equal.
* A mean over counted slots divides the rank's sum by `shard_denominator`
  of the count: the count summed over the batch shards (detached) over
  their number; outside `batch_reduction` the count itself.
* `average_over_ranks` averages each gradient over the axes that split
  the batch, the sequence or the stack, ``data``, ``fsdp``, ``seq`` and
  ``pp``, with one
  all-reduce of a flat fp32 buffer per group of leaves (and the step's
  metrics with them), before the clip, so the clip and the optimizer see
  the global gradient.  A leaf split over ``fsdp`` arrives reduce-scattered
  over that axis already (`parallel.tensor_parallel.materialize`) and is
  reduced over the others only; a leaf split over ``tensor`` or
  ``expert`` holds another slice on each rank of those axes and is never
  summed over them.

Under sequence parallelism the ranks of a ``seq`` line hold the same rows
and compute the same losses; the stack's gather scales its backward by the
line's length (`parallel/sp.py`), so the same average gives the global
gradient there too.  Under pipeline parallelism the ranks of a ``pp`` line
hold the same rows too: a block's gradient arises on its stage alone, S
times over (`parallel/pipeline.py`), and the average over ``pp`` makes it
whole on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from m3p_tpu_torch.parallel import mesh as M

# bytes of gradient (and metric) buffer all-reduced per rank
REDUCED_BYTES = {"gradients": 0, "steps": 0}

# the axes a batch is split over, and those a gradient is averaged over
BATCH_AXES = ("data", "fsdp")
GRAD_AXES = ("data", "fsdp", "seq", "pp")

_ACTIVE: List[M.Mesh] = []


@contextlib.contextmanager
def batch_reduction(mesh: Optional[M.Mesh]) -> Iterator[None]:
    """Within the block, `shard_denominator` and `gather_batch` reduce over the
    batch shards of ``mesh`` (a no-op for None or one shard)."""
    if mesh is None or mesh.batch_shards[1] == 1:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def batch_mesh() -> Optional[M.Mesh]:
    """The mesh whose batch shards `batch_reduction` reduces over, or
    None outside it (or over one shard)."""
    return _ACTIVE[-1] if _ACTIVE else None


def _global_sum(count: torch.Tensor) -> torch.Tensor:
    """``count`` summed over the batch shards, detached."""
    mesh = _ACTIVE[-1]
    total = M.all_reduce_sum(count.detach().float().reshape(1), mesh,
                             mesh.group(BATCH_AXES))
    return total.reshape(count.shape).to(count.dtype)


def shard_denominator(count: torch.Tensor, floor: float = 1.0
                      ) -> torch.Tensor:
    """The denominator of a mean over counted slots: ``max(count, floor)``
    on one shard; under `batch_reduction` the global count (detached,
    floored) over the number of shards, so that a rank's sum over it
    averages over the shards to the global sum over the global count."""
    if not _ACTIVE:
        return count.clamp_min(floor)
    return _global_sum(count).clamp_min(floor) / _ACTIVE[-1].batch_shards[1]


def shard_scale() -> int:
    """The number of batch shards (1 outside `batch_reduction`): a metric
    that is a sum over the batch is multiplied by it."""
    if not _ACTIVE:
        return 1
    return _ACTIVE[-1].batch_shards[1]


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """``x`` of every batch shard concatenated along dim 0 in shard order
    (the global batch's rows), detached; ``x`` outside `batch_reduction`."""
    if not _ACTIVE:
        return x
    mesh = _ACTIVE[-1]
    return M.all_gather_cat(x.detach().contiguous(), mesh, BATCH_AXES)


def shard_position() -> tuple:
    """(index, count) of this rank's batch shard; (0, 1) outside
    `batch_reduction`."""
    if not _ACTIVE:
        return 0, 1
    return _ACTIVE[-1].batch_shards


def _fsdp_split(p: torch.Tensor) -> bool:
    spec = getattr(p, "shard", None)
    return spec is not None and "fsdp" in spec.axes


def average_over_ranks(mesh: M.Mesh,
                       params: Sequence[torch.nn.Parameter],
                       metrics: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Optional[Dict[str, torch.Tensor]]:
    """Replace every ``p.grad`` by its mean over the batch and sequence
    shards (`GRAD_AXES`; a missing gradient counts as zeros, as the JAX
    gradient tree holds them) and return ``metrics`` averaged the same way:
    one all-reduce of a flat fp32 buffer over ``GRAD_AXES`` and, for the
    leaves split over ``fsdp`` (their sum over it taken already), one over
    the others."""
    params = list(params)
    names = sorted(metrics or {})
    n = mesh.count(GRAD_AXES)
    dev = params[0].device
    REDUCED_BYTES["steps"] += 1
    out = None if metrics is None else dict(metrics)
    for split in (False, True):
        leaves = [p for p in params if _fsdp_split(p) == split]
        axes = (tuple(a for a in GRAD_AXES if a != "fsdp") if split
                else GRAD_AXES)
        extra = [] if split else names
        if not leaves and not extra:
            continue
        parts = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 .reshape(-1).float() for p in leaves]
        parts += [metrics[k].detach().float().reshape(1).to(dev)
                  for k in extra]
        flat = torch.cat(parts)
        if mesh.group(axes) is not None:
            REDUCED_BYTES["gradients"] += flat.numel() * 4
            flat = M.all_reduce_sum(flat, mesh, mesh.group(axes))
        flat = flat / n
        offset = 0
        for p in leaves:
            k = p.numel()
            p.grad = flat[offset:offset + k].view(p.shape).to(p.dtype)
            offset += k
        for k in extra:
            out[k] = flat[offset].to(metrics[k].dtype)
            offset += 1
    return out
