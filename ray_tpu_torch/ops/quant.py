"""Weight-only int8 quantization for serving, W8A16 (port of ray_tpu/ops/quant.py).

Per-output-channel symmetric quantization: scales are max|w| / 127 over the
contraction axis, one per output unit, kept with that axis as 1 so that they
broadcast against the weight. The rounding is the jitted JAX module's bit for
bit: XLA folds the division by the constant 127 into a product with its f32
reciprocal, so the scale is amax * f32(1/127) here too; w / scale and the
round-half-to-even run in f32; and ``dequant`` rounds the scale to the target
dtype before the product, as ``q.astype(dtype) * s.astype(dtype)`` does.

Unlike XLA, which fuses the int8 convert and the scale into the matmul's
operand read, ``as_weight`` here materialises the dequantized weight at each
use: the int8 bytes halve what the model holds, not what a step reads
(a fused W8A16 GEMM is ROADMAP queue B).

``quantize_blockwise`` / ``dequant_blockwise`` (the gradient-sync reduction
format) and ``quantize_np`` / ``dequant_np`` (the collective wire format)
complete the module; the port's grad sync (ROADMAP A8) does not call them yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

# 1/127 rounded to f32: XLA's form of "/ 127.0" under jit (an f32 constant
# reciprocal), which a Python float keeps exactly
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


class QTensor(NamedTuple):
    """int8 weight + per-output-channel scales. Rides in a parameter dict as a
    leaf; a stacked [L, ...] weight has per-layer scales [L, ...]."""

    q: torch.Tensor  # int8, the weight's shape
    s: torch.Tensor  # f32, the weight's shape with the contraction axis kept as 1

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return sum(t.nelement() * t.element_size() for t in self)

    def layer(self, i: int) -> "QTensor":
        """Layer i of a stacked QTensor (views)."""
        return QTensor(self.q[i], self.s[i])


def quantize(w: torch.Tensor, contract_axis: int = 0) -> QTensor:
    """Symmetric per-output-channel int8 quantization over contract_axis.
    The division, rounding and clamp run in place on one f32 copy of w, so
    the peak holds w and two f32 copies of it (the copy and |w|)."""
    wf = w.to(torch.float32, copy=True)
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    scale = torch.clamp_min(amax * _INV_127, 1e-12)
    q = wf.div_(scale).round_().clamp_(-127, 127)
    return QTensor(q=q.to(torch.int8), s=scale)


def dequant(t: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """Rehydrate to `dtype`: q and s each cast to it, then multiplied in it."""
    return t.q.to(dtype) * t.s.to(dtype)


def as_weight(p: Any, dtype: torch.dtype) -> torch.Tensor:
    """THE accessor model code uses: dequants a QTensor, casts a plain tensor."""
    if isinstance(p, QTensor):
        return dequant(p, dtype)
    return p.to(dtype)


# -- device-side blockwise int8 (gradient-sync reduction format) -----------------------

def quantize_blockwise(x: torch.Tensor, block_elems: int = 1024,
                       generator: Optional[torch.Generator] = None):
    """Blockwise symmetric int8 of any-shape `x` (flattened): returns
    (q int8 [nblocks, block_elems], scales f32 [nblocks, 1]); the tail block is
    zero-padded. A `generator` switches round-nearest to stochastic rounding,
    floor(x/scale + u) with u ~ U[0, 1) (the draws are not jax.random's)."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    nblocks = max(1, -(-n // block_elems))
    pad = nblocks * block_elems - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(nblocks, block_elems)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax * _INV_127, 1e-12)
    scaled = blocks / scale
    if generator is not None:
        u = torch.rand(blocks.shape, generator=generator, device=blocks.device)
        q = torch.floor(scaled + u)
    else:
        q = torch.round(scaled)
    return q.clamp(-127, 127).to(torch.int8), scale


def dequant_blockwise(q: torch.Tensor, scales: torch.Tensor, n: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Inverse of quantize_blockwise: flat [n] tensor of `dtype`."""
    out = q.float() * scales
    return out.reshape(-1)[:n].to(dtype)


# -- host-side blockwise int8 (collective wire format) ---------------------------------

def quantize_np(x: np.ndarray, block_elems: int = 4096):
    """Blockwise symmetric int8: returns (q int8 [n], scales f32 [ceil(n/block)])."""
    flat = np.ascontiguousarray(x).reshape(-1).astype(np.float32, copy=False)
    n = flat.size
    if n == 0:
        return np.empty(0, np.int8), np.empty(0, np.float32)
    nblocks = -(-n // block_elems)
    pad = nblocks * block_elems - n
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(nblocks, block_elems)
    amax = np.abs(blocks).max(axis=1)
    scales = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(blocks / scales[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1)[:n], scales


def dequant_np(q: np.ndarray, scales: np.ndarray, block_elems: int, dtype):
    """Inverse of quantize_np; returns a 1-D array of `dtype` with q.size elements."""
    n = q.size
    if n == 0:
        return np.empty(0, dtype)
    nblocks = scales.size
    pad = nblocks * block_elems - n
    full = np.concatenate([q, np.zeros(pad, np.int8)]) if pad else q
    out = full.reshape(nblocks, block_elems).astype(np.float32) * scales[:, None]
    return out.reshape(-1)[:n].astype(dtype)


# Llama layer weights eligible for weight-only quantization, all stored with
# d_in first after the stacked [L] axis (the embedding table and the norms
# stay as they are: gathers and elementwise ops stream no per-token weight
# bytes the way matmuls do). In a MoE layer (marked by its "router") the MLP
# keys hold expert stacks [L, E, d_in, out], which contract over axis 2. The
# router [L, d, E] stays in the float dtype: it is tiny, and routing is the
# accuracy-critical part.
LLAMA_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def layer_contract_axis(name: str, layer_keys) -> int:
    """Contraction axis of a stacked layer leaf: d_in after [L] (1), or
    after [L, E] (2) for an expert stack. Rank cannot tell them apart: the
    attention projections are rank 4 too (ray_tpu/ops/quant.py:158-163)."""
    return 2 if "router" in layer_keys and name in EXPERT_KEYS else 1


def scale_shape(shape, axis: int) -> tuple:
    """The scales' shape of a weight of `shape` contracted over `axis`."""
    return tuple(shape[:axis]) + (1,) + tuple(shape[axis + 1:])


def empty_qtensor(shape, axis: int, device) -> QTensor:
    """An uninitialised QTensor of `shape` whose scales keep `axis` as 1."""
    return QTensor(torch.empty(shape, dtype=torch.int8, device=device),
                   torch.empty(scale_shape(shape, axis), dtype=torch.float32, device=device))


def quantize_layer(w: torch.Tensor, axis: int) -> QTensor:
    """One layer's piece of a stacked weight (w: that layer), quantized over
    the stacked leaf's contraction axis: d_in (axis 1), or d_in of each
    expert (axis 2), the same bits as quantize_layer_ stores."""
    return quantize(w, axis - 1)


def quantize_layer_(dst: QTensor, i: int, w: torch.Tensor, axis: int) -> None:
    """Quantize layer i of a stacked weight (w: that layer) into dst in
    place, over the stacked leaf's contraction axis. An expert stack goes
    one expert at a time (the same amax per output unit, so the same bits),
    which holds one expert's f32 temporaries rather than the layer's."""
    if axis == 2:
        for e in range(w.shape[0]):
            dst.q[i, e], dst.s[i, e] = quantize(w[e], 0)
    else:
        dst.q[i], dst.s[i] = quantize(w, 0)


@torch.no_grad()
def quantize_llama_params(params: dict) -> dict:
    """Quantize a llama parameter dict's layer matmuls and an untied lm_head.

    Layers are stacked on [L], so each layer is quantized on its own (per-layer
    scales, as the JAX package's vmap over the scanned axis gives) into one
    preallocated int8 tensor: the peak holds one layer's f32 temporaries, not
    a second copy of the model. Expert stacks quantize per (expert, output
    unit) over d_in, with scales [L, E, 1, out]. A leaf that is already a
    QTensor stays as it is."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in LLAMA_QUANT_KEYS:
        w = layers[name]
        if isinstance(w, QTensor):
            continue
        axis = layer_contract_axis(name, layers)
        dst = empty_qtensor(w.shape, axis, w.device)
        for i in range(w.shape[0]):
            quantize_layer_(dst, i, w[i], axis)
        layers[name] = dst
    out["layers"] = layers
    if "lm_head" in params and not isinstance(params["lm_head"], QTensor):
        # the untied head [d_model, vocab] is often the largest single weight
        # a decode step reads; every head consumer goes through as_weight
        out["lm_head"] = quantize(params["lm_head"], 0)
    return out
