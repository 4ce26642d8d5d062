"""Device meshes, logical-axis sharding rules, the collectives of tensor
parallelism and the hop between pipeline stages (port of
ray_tpu/parallel/mesh.py and sharding.py)."""
from .mesh import AXIS_ORDER, MeshSpec, axis_index, axis_size, build_mesh, mesh_backend
from .sharding import (INFER_RULES, TRAIN_RULES, AxisRules, all_gather, all_reduce,
                       copy_to, cut_axes, gather_leaf, gather_shard, local_range,
                       local_shape, logical_to_mesh_axes, shard_leaf, shard_pytree, shard_view)

__all__ = ["AXIS_ORDER", "MeshSpec", "build_mesh", "mesh_backend", "axis_size",
           "axis_index", "AxisRules", "TRAIN_RULES", "INFER_RULES", "logical_to_mesh_axes",
           "shard_pytree", "shard_leaf", "shard_view", "local_shape", "local_range", "cut_axes",
           "all_reduce", "all_gather", "copy_to", "gather_shard", "gather_leaf"]
