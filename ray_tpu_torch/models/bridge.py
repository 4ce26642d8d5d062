"""Carry Llama weights and optimizer state between the JAX package's pytrees
and the port.

Both packages keep the same tree and the same einsum layout, so the bridge
moves arrays as they are: no transposes anywhere, and every leaf's shape is
checked against ``llama.param_shapes(cfg)``. The JAX side is handed over as
numpy (``jax.tree_util.tree_map(np.asarray, params)``); this module never
imports JAX or optax. An int8 leaf (the JAX package's ``QTensor``, from
``quantize_llama_params``) crosses as its ``q`` and ``s`` both ways and
becomes the port's ``ops.quant.QTensor``: q stays int8, s f32, its shape the
weight's with the contraction axis kept as 1 (axis 2 for an expert stack
[L, E, d_in, out], 1 for the other layer leaves, 0 for the head). With a
device mesh, ``params_from_jax`` returns this rank's shard of the tree
(``parallel.shard_pytree`` by ``llama.param_axes`` and the given rules),
which a test holds against the JAX leaf's shard on the same mesh
coordinates.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.quant import QTensor, layer_contract_axis, scale_shape
from ray_tpu_torch.parallel.sharding import INFER_RULES, AxisRules, shard_pytree
from ray_tpu_torch.train.optim import AdamWState

from . import llama
from .config import ModelConfig


def _is_qtensor(x) -> bool:
    """A QTensor of either package: a named tuple of (q, s)."""
    return isinstance(x, tuple) and getattr(x, "_fields", None) == ("q", "s")


def _leaf(arr, shape, where: str, device, dtype, axis: int = 0):
    """One leaf; `axis` is its contraction axis, which an int8 leaf's scales
    keep as 1."""
    if _is_qtensor(arr):
        q, s = np.asarray(arr.q), np.asarray(arr.s)
        if q.dtype != np.int8:
            raise ValueError(f"{where}: q is {q.dtype}, expected int8")
        return QTensor(_leaf(q, shape, f"{where}.q", device, torch.int8),
                       _leaf(s, scale_shape(shape, axis), f"{where}.s", device, torch.float32))
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot read
        arr = arr.astype(np.float32)  # exact; `dtype` rounds it back
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{where}: shape {tuple(arr.shape)} != expected {tuple(shape)}")
    # np.array copies: the port never aliases the caller's (read-only) buffers
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: torch.dtype = torch.float32, mesh=None,
                    rules: AxisRules = INFER_RULES) -> llama.Params:
    """JAX llama pytree (numpy leaves) -> the port's parameter dict on `device`
    (with a `mesh`, this rank's shard of it by `rules`).

    A JAX tree with per-layer lists (scan_layers=False) is stacked on [L].
    int8 leaves (of a scanned tree) keep their dtypes whatever `dtype` is."""
    dev = resolve_device(device)
    shapes = llama.param_shapes(cfg)
    want = set(shapes)
    if set(tree) != want:
        raise ValueError(f"top-level keys {sorted(tree)} != expected {sorted(want)}")
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        layers = {name: np.stack([np.asarray(lyr[name]) for lyr in layers])
                  for name in layers[0]}
    if set(layers) != set(shapes["layers"]):
        raise ValueError(f"layer keys {sorted(layers)} != expected "
                         f"{sorted(shapes['layers'])}")
    ls = shapes["layers"]
    out: llama.Params = {
        "layers": {name: _leaf(layers[name], shape, f"layers/{name}", dev, dtype,
                               layer_contract_axis(name, ls))
                   for name, shape in ls.items()},
    }
    for name, shape in shapes.items():
        if name != "layers":
            out[name] = _leaf(tree[name], shape, name, dev, dtype)
    return out if mesh is None else shard_pytree(out, llama.param_axes(cfg), mesh, rules)


def params_to_numpy(params: llama.Params) -> Dict[str, Any]:
    """The port's parameters -> a numpy tree in the JAX layout (f32 for bf16,
    which numpy lacks; f32 tensors come back bit for bit). A QTensor comes
    back as a QTensor of numpy q and s, from which a test rebuilds the JAX
    package's own."""

    def to_np(t):
        if isinstance(t, QTensor):
            return QTensor(to_np(t.q), to_np(t.s))
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {name: ({k: to_np(v) for k, v in val.items()} if name == "layers"
                   else to_np(val))
            for name, val in params.items()}


def opt_state_from_jax(tree, cfg: ModelConfig, device=None,
                       mu_dtype: torch.dtype = torch.float32) -> AdamWState:
    """The optax state of ray_tpu/train/step.py:make_optimizer (numpy leaves)
    -> the port's optim.AdamWState on `device`.

    That state is ``(EmptyState, (ScaleByAdamState(count, mu, nu), EmptyState,
    ScaleByScheduleState(count)))``: clipping and weight decay keep none, and
    the two counts are equal. mu is stored in `mu_dtype` (make_optimizer's
    mu_dtype, f32 by default), nu in f32, both in llama.tree_leaves order."""
    adam, sched = tree[1][0], tree[1][2]
    count = int(np.asarray(adam.count))
    if int(np.asarray(sched.count)) != count:
        raise ValueError(f"adam count {count} != schedule count {sched.count}")
    mu = params_from_jax(adam.mu, cfg, device, dtype=mu_dtype)
    nu = params_from_jax(adam.nu, cfg, device)
    return AdamWState(count, llama.tree_leaves(mu), llama.tree_leaves(nu))


def opt_state_to_numpy(state: AdamWState, params: llama.Params) -> Dict[str, Any]:
    """optim.AdamWState -> {"count": int, "mu": tree, "nu": tree} with numpy
    trees in the JAX layout (bf16 moments come back as f32), from which a
    test rebuilds optax's ScaleByAdamState and ScaleByScheduleState."""
    return {"count": state.count,
            "mu": params_to_numpy(llama.tree_unflatten(params, state.mu)),
            "nu": params_to_numpy(llama.tree_unflatten(params, state.nu))}
