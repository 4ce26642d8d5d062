"""Logical-axis sharding rules and the tensor-parallel collectives (port of
ray_tpu/parallel/sharding.py).

Model code names each array's axes logically ("embed", "heads", "vocab", ...);
one ``AxisRules`` table maps logical names to mesh axes, so the parallelism
strategy is the table, not the model. ``shard_pytree`` gives each rank its
LOCAL shard as a plain tensor (the slice along every dim whose logical axis
maps to mesh axes of more than one rank), where JAX device_puts a global
array: the hand kernels take plain tensors, and the model code calls the
collectives itself (``all_reduce`` after a contraction over a sharded axis,
``all_gather`` to join a sharded output). An int8 ``QTensor`` shards with its
weight: q like the float leaf, its scales likewise except along the
contraction axis they keep as 1 (replicated where that axis is sharded, as
XLA leaves them: ray_tpu/ops/quant.py:24-31).

``with_sharding_constraint``, ``manual_axes``, ``vary_like`` and the
shard_map helpers serve sequence and pipeline parallelism (ROADMAP A6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.quant import QTensor

from .mesh import axis_index, axis_size

LogicalAxis = Optional[str]
MeshAxes = Union[None, str, Tuple[str, ...]]


class AxisRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    def __init__(self, rules: Dict[str, MeshAxes]):
        self.rules = dict(rules)

    def __getitem__(self, logical: LogicalAxis) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, logical_axes: Sequence[LogicalAxis]) -> Tuple[MeshAxes, ...]:
        return tuple(self[a] for a in logical_axes)


# Default rules for transformer training (ray_tpu/parallel/sharding.py:36-57).
TRAIN_RULES = AxisRules(
    {
        # parameters
        "embed": "fsdp",
        "heads": "tp",
        "kv_heads": "tp",
        "head_dim": None,
        "mlp": "tp",
        "vocab": "tp",
        "expert": "ep",
        "stage": "pp",
        # activations
        "batch": ("dp", "fsdp"),
        "seq": "sp",
        "act_embed": None,
        "act_heads": "tp",
        "act_kv_heads": "tp",
        "act_mlp": "tp",
        "act_vocab": "tp",
        "act_expert": "ep",
    }
)

# Inference: params replicated across dp, sharded over tp; KV cache sharded
# over heads (tp) and batch (dp).
INFER_RULES = AxisRules(
    {
        "embed": None,
        "heads": "tp",
        "kv_heads": "tp",
        "head_dim": None,
        "mlp": "tp",
        "vocab": "tp",
        "expert": "ep",
        "stage": "pp",
        "batch": "dp",
        "seq": "sp",
        "act_embed": None,
        "act_heads": "tp",
        "act_kv_heads": "tp",
        "act_mlp": "tp",
        "act_vocab": "tp",
        "act_expert": "ep",
    }
)


def logical_to_mesh_axes(logical_axes: Sequence[LogicalAxis],
                         rules: AxisRules = TRAIN_RULES) -> Tuple[MeshAxes, ...]:
    """The mesh axes of each dim, as JAX's PartitionSpec lists them."""
    return rules.spec(logical_axes)


def _slices(shape, axes, mesh, rules: AxisRules) -> Tuple[slice, ...]:
    """This rank's slice of each dim: a dim whose mesh axes hold n > 1 ranks
    is cut in n equal parts, taken major axis first (a PartitionSpec's
    tuple order)."""
    out = []
    for size, mesh_axes in zip(shape, rules.spec(axes)):
        names = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes or ())
        n, idx = 1, 0
        for name in names:
            k = axis_size(mesh, name)
            idx, n = idx * k + axis_index(mesh, name), n * k
        if n == 1:
            out.append(slice(None))
            continue
        if size % n:
            raise ValueError(f"a dim of {size} does not divide over {names} ({n} ranks)")
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shape(shape, axes, mesh, rules: AxisRules) -> Tuple[int, ...]:
    """The shape of this rank's shard of an array of `shape`."""
    return tuple(len(range(*s.indices(n))) for s, n in zip(_slices(shape, axes, mesh, rules),
                                                             shape))


def shard_view(x: Any, axes, mesh, rules: AxisRules) -> Any:
    """This rank's shard of one leaf as a view of it (`x` itself when no dim
    is cut). A QTensor's scales keep their size-1 contraction axis whole."""
    if isinstance(x, QTensor):
        sl = _slices(x.q.shape, axes, mesh, rules)
        s_sl = tuple(slice(None) if ns == 1 else s for s, ns in zip(sl, x.s.shape))
        return QTensor(x.q[sl], x.s[s_sl])
    return x[_slices(x.shape, axes, mesh, rules)]


def shard_leaf(x: Any, axes, mesh, rules: AxisRules) -> Any:
    """This rank's shard of one leaf as a copy, so the whole can be freed
    (`x` itself when no dim is cut)."""
    view = shard_view(x, axes, mesh, rules)
    parts, whole = (view, x) if isinstance(x, QTensor) else ((view,), (x,))
    if all(p.shape == w.shape for p, w in zip(parts, whole)):
        return x
    out = [p.clone(memory_format=torch.contiguous_format) for p in parts]
    return QTensor(*out) if isinstance(x, QTensor) else out[0]


def shard_pytree(tree, axes_tree, mesh, rules: AxisRules):
    """Each rank's local shard of a dict tree, by a parallel tree of
    logical-axes tuples (one name or None per dim of each leaf)."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, axes_tree[k], mesh, rules) for k, v in tree.items()}
    return shard_leaf(tree, axes_tree, mesh, rules)


def all_reduce(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Sum x over the ranks of a mesh axis, in place (the identity for one
    rank or no mesh)."""
    if axis_size(mesh, axis) > 1:
        dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """The ranks' x joined along `dim`, in rank order along the mesh axis
    (x itself for one rank or no mesh)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)
