"""Several processes: the mesh, data parallelism and sequence parallelism
(counterpart of `m3p_tpu/parallel`).  Exports what
`m3p_tpu/parallel/__init__.py` exports, for what is ported; the logical
parameter rules and train-state sharding are item 16b of ROADMAP.md."""

from m3p_tpu_torch.parallel.mesh import infer_mesh_shape, make_mesh
from m3p_tpu_torch.parallel.sharding import batch_sharding

__all__ = ["batch_sharding", "infer_mesh_shape", "make_mesh"]
