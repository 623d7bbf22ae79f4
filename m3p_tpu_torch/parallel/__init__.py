"""Several processes: the mesh, data parallelism, parameter sharding and
sequence parallelism (counterpart of `m3p_tpu/parallel`).  Exports what
`m3p_tpu/parallel/__init__.py` exports (`model_param_specs` for
`get_param_pspecs`); the pipeline is item 16c of ROADMAP.md."""

from m3p_tpu_torch.parallel.mesh import infer_mesh_shape, make_mesh
from m3p_tpu_torch.parallel.sharding import (
    LOGICAL_RULES, batch_sharding, model_param_specs, shard_train_state)

__all__ = ["LOGICAL_RULES", "batch_sharding", "infer_mesh_shape",
           "make_mesh", "model_param_specs", "shard_train_state"]
