"""Logical-axis sharding rules and the tensor-parallel collectives (port of
ray_tpu/parallel/sharding.py).

Model code names each array's axes logically ("embed", "heads", "vocab", ...);
one ``AxisRules`` table maps logical names to mesh axes, so the parallelism
strategy is the table, not the model. ``shard_pytree`` gives each rank its
LOCAL shard as a plain tensor (the slice along every dim whose logical axis
maps to mesh axes of more than one rank), where JAX device_puts a global
array: the hand kernels take plain tensors, and the model code calls the
collectives itself where GSPMD would insert them. An int8 ``QTensor`` shards with its
weight: q like the float leaf, its scales likewise except along the
contraction axis they keep as 1 (replicated where that axis is sharded, as
XLA leaves them: ray_tpu/ops/quant.py:24-31).

The collectives are differentiable, Megatron's f/g pair and an fsdp
gather, each over one mesh axis's group:

- ``all_reduce``: the sum forward, the identity backward (g: after a
  row-parallel product, whose downstream every rank of the axis computes
  alike);
- ``copy_to``: the identity forward, the sum of the gradients backward (f:
  at the input of a column-parallel product);
- ``all_gather``: the ranks' pieces joined forward, this rank's slice of
  the gradient backward (the downstream is replicated over the axis);
- ``gather_shard``: a parameter's fsdp shards joined forward, the gradient
  summed over the axis and sliced backward (a reduce-scatter: each rank's
  downstream saw its own slice of the batch). Gloo has no reduce-scatter of
  one tensor, so it is an all-reduce and a slice, the same values.

Without autograd (``torch.no_grad()``, or an input that does not require
grad) each is the plain call, ``all_reduce`` in place: serving keeps its
bits.

``with_sharding_constraint``, ``manual_axes``, ``vary_like`` and the
shard_map helpers serve sequence parallelism (ROADMAP A6); pipeline stages
hand activations on by parallel/pipeline.py.
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


def local_range(size: int, axis: LogicalAxis, mesh, rules: AxisRules) -> range:
    """The indices of a dim of `size` with logical `axis` that this rank
    holds (e.g. a pipeline stage's layers, "layer" cut over "pp")."""
    return range(size)[_slices((size,), (axis,), mesh, rules)[0]]


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


def cut_axes(axes, mesh, rules: AxisRules) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that cut a leaf with logical
    `axes`, in the order of its dims."""
    out = []
    for mesh_axes in rules.spec(axes):
        names = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes or ())
        out += [a for a in names if axis_size(mesh, a) > 1 and a not in out]
    return tuple(out)


def _grad_wanted(x) -> bool:
    return torch.is_grad_enabled() and isinstance(x, torch.Tensor) and x.requires_grad


def _gather_cat(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumForward(torch.autograd.Function):
    """g: the sum over a group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """f: the identity forward, the gradients summed over a group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _GatherSlice(torch.autograd.Function):
    """The group's pieces joined along `dim` forward; backward, this rank's
    slice of the gradient (`summed`: of the gradient summed over the group
    first, a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim, summed):
        ctx.group, ctx.index, ctx.dim, ctx.summed = group, index, dim, summed
        ctx.size = x.shape[dim]
        return _gather_cat(x, group, n, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            grad = _summed(grad, ctx.group)
        grad = grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous()
        return grad, None, None, None, None, None


def all_reduce(x: torch.Tensor, mesh, axis: str = "tp", op: str = "sum") -> torch.Tensor:
    """Sum (or, op="max", the maximum of) x over the ranks of a mesh axis:
    the identity for one rank or no mesh. Without autograd it runs in place;
    under autograd the sum is g (the identity backward), and the maximum
    takes no gradient."""
    if axis_size(mesh, axis) == 1:
        return x
    group = mesh.get_group(axis)
    if op == "max":
        if _grad_wanted(x) or not x.is_contiguous():
            raise ValueError("all_reduce(op='max') runs in place, without a gradient: pass "
                             "a detached contiguous tensor")
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
        return x
    if op != "sum":
        raise ValueError(f"op {op!r} (expected sum | max)")
    if _grad_wanted(x):
        return _SumForward.apply(x, group)
    if not x.is_contiguous():  # gloo would reduce the storage, not the view
        raise ValueError("all_reduce in place needs a contiguous tensor")
    dist.all_reduce(x, group=group)
    return x


def copy_to(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """f: x itself forward; under autograd its gradient is summed over the
    ranks of a mesh axis (the input of a column-parallel product)."""
    if axis_size(mesh, axis) == 1 or not _grad_wanted(x):
        return x
    return _SumBackward.apply(x, mesh.get_group(axis))


def all_gather(x: torch.Tensor, mesh, axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """The ranks' x joined along `dim`, in rank order along the mesh axis
    (x itself for one rank or no mesh). Under autograd the backward keeps
    this rank's slice of the gradient."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    group = mesh.get_group(axis)
    if _grad_wanted(x):
        return _GatherSlice.apply(x, group, n, axis_index(mesh, axis), dim % x.dim(), False)
    return _gather_cat(x, group, n, dim)


def gather_shard(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """A parameter's shards over a mesh axis joined along `dim` (x itself
    for one rank). Under autograd the backward sums the gradient over the
    axis's ranks and keeps this rank's slice: a reduce-scatter."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    group = mesh.get_group(axis)
    if _grad_wanted(x):
        return _GatherSlice.apply(x, group, n, axis_index(mesh, axis), dim % x.dim(), True)
    return _gather_cat(x, group, n, dim)


def gather_leaf(x: torch.Tensor, axes, mesh, rules: AxisRules,
                axis: str = "fsdp") -> torch.Tensor:
    """One leaf joined along every dim whose logical axis `rules` maps to the
    mesh axis `axis` alone (gather_shard): a layer's weights gathered over
    fsdp where they are used. x itself when no such dim is cut."""
    if axis_size(mesh, axis) == 1:
        return x
    for dim, mesh_axes in enumerate(rules.spec(axes)):
        if mesh_axes == axis:
            x = gather_shard(x, mesh, axis, dim)
        elif not isinstance(mesh_axes, str) and axis in (mesh_axes or ()):
            raise NotImplementedError(f"a parameter dim over mesh axes {mesh_axes}: "
                                      "ROADMAP A6")
    return x
