"""Carry Llama weights between the JAX package's pytree and the port.

Both packages keep the same tree and the same einsum layout, so the bridge
moves arrays as they are: no transposes anywhere, and every leaf's shape is
checked against ``llama.param_shapes(cfg)``. The JAX side is handed over as
numpy (``jax.tree_util.tree_map(np.asarray, params)``); this module never
imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device

from . import llama
from .config import ModelConfig


def _leaf(arr, shape, where: str, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{where}: shape {tuple(arr.shape)} != expected {tuple(shape)}")
    # np.array copies: the port never aliases the caller's (read-only) buffers
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: torch.dtype = torch.float32) -> llama.Params:
    """JAX llama pytree (numpy leaves) -> the port's parameter dict on `device`.

    A JAX tree with per-layer lists (scan_layers=False) is stacked on [L]."""
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
    out: llama.Params = {
        "layers": {name: _leaf(layers[name], shape, f"layers/{name}", dev, dtype)
                   for name, shape in shapes["layers"].items()},
    }
    for name, shape in shapes.items():
        if name != "layers":
            out[name] = _leaf(tree[name], shape, name, dev, dtype)
    return out


def params_to_numpy(params: llama.Params) -> Dict[str, Any]:
    """The port's parameters -> a numpy tree in the JAX layout (f32 for bf16,
    which numpy lacks; f32 tensors come back bit for bit)."""

    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {name: ({k: to_np(v) for k, v in val.items()} if name == "layers"
                   else to_np(val))
            for name, val in params.items()}
