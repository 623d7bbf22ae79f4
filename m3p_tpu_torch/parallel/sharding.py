"""The batch's sharding over the mesh (the part of
`m3p_tpu/parallel/sharding.py` that data parallelism needs).

The JAX package shards the leading batch dimension over ("data", "fsdp")
(`batch_sharding`) and its parameters by logical axes.  Here every rank
holds whole parameters; a rank's batch is its shard of the global batch:
ranks that differ only in ``seq`` hold the same rows.  Parameter sharding
over ``fsdp`` / ``tensor`` / ``expert`` and the ``pp`` axis are items 16b
and 16c of ROADMAP.md: a mesh that uses them raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from m3p_tpu_torch.parallel.mesh import Mesh

_UNPORTED = {"fsdp": "16b", "tensor": "16b", "expert": "16b", "pp": "16c"}


def check_mesh_supported(shape: Dict[str, int]) -> None:
    """Raise NotImplementedError for a mesh axis the port does not shard
    over yet (``fsdp`` / ``tensor`` / ``expert``: item 16b; ``pp``: item
    16c of ROADMAP.md)."""
    for axis, item in _UNPORTED.items():
        if shape.get(axis, 1) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={shape[axis]}: parameter sharding and "
                f"the pipeline are item {item} of ROADMAP.md; the port "
                "shards over data and seq only")


@dataclass(frozen=True)
class BatchSharding:
    """This rank's shard of a global batch: rows ``index * n / count`` to
    ``(index + 1) * n / count`` of an ``n``-row batch."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.count} batch shards")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """The leading batch dimension over ("data", "fsdp"); everything else
    replicated (`m3p_tpu/parallel/sharding.py:50-52`)."""
    check_mesh_supported(mesh.shape)
    return BatchSharding(*mesh.batch_shards)


def shard_batch(batch: Any, sharding: BatchSharding) -> Any:
    """This rank's rows of a global batch: a dict (or tuple of dicts) of
    arrays whose leading dimension is the batch."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, sharding) for b in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v, sharding) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) or hasattr(batch, "shape"):
        return batch[sharding.rows(batch.shape[0])]
    return batch
