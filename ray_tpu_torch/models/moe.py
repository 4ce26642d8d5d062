"""Mixture-of-experts MLP with static capacity-based dispatch (port of
ray_tpu/models/moe.py).

The GShard/Switch pattern as einsums over one-hot dispatch masks: every shape
is static (tokens x experts x capacity). Tokens are processed in fixed-size
groups, so the dispatch tensors stay linear in the sequence length; within a
group each expert takes at most C = int(capacity_factor * k * g / E) + 1
tokens (at least 4, at most g). Every token's top-1 pick claims capacity
before any top-2 pick (slot-major order), masked tokens (padding, inactive
decode slots) claim none, and a pick past C is dropped with its gate weight:
the token's output is underweighted by that share, with no renormalisation
over the survivors. With top_k = 1 the raw router probability gates the
output (Switch) unless moe_top1_renorm; with top_k > 1 the top-k gates
renormalise to sum to 1 (Mixtral).

The router logits are f32; dispatch and combine are built in f32 and cast to
the activation dtype for the expert einsums, as the JAX module does. The
expert products run as torch.einsum (batched GEMMs): JAX computes them
outside any Pallas kernel. Expert weights are read through
``ops.quant.as_weight``, so int8 expert stacks dequantize at use.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.quant import as_weight

from .config import ModelConfig

# Tokens per dispatch group: the JAX package's knob default
# (RAY_TPU_MOE_GROUP_SIZE). Dispatch and combine are [g, E, C] with C ~ g/E,
# so a group's memory is O(g^2) and the whole is O(T*g).
MOE_GROUP_SIZE = 4096


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.moe_capacity_factor * cfg.moe_top_k * n_tokens / cfg.n_experts) + 1
    return max(4, min(c, n_tokens))


def _group_size(t: int) -> int:
    """Largest divisor of t that is <= MOE_GROUP_SIZE (equal groups)."""
    cap = MOE_GROUP_SIZE
    if t <= cap:
        return t
    for g in range(cap, 0, -1):
        if t % g == 0:
            return g
    return t


def top_k(probs: torch.Tensor, k: int):
    """The k largest probabilities of each row and their experts, descending,
    the lower index first among equal values, as jax.lax.top_k orders them
    (torch.topk promises no order for ties, and a bf16 router meets ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_group(x, mask, router_w, w_gate, w_up, w_down, cfg: ModelConfig):
    """Dispatch one token group. x [g, D]; mask [g] f32, 1 = real token; the
    weights in x's dtype."""
    g = x.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    c = expert_capacity(cfg, g)
    dt = x.dtype

    logits = torch.einsum("td,de->te", x, router_w).float()
    probs = torch.softmax(logits, dim=-1)  # [g, E]
    gate_vals, gate_idx = top_k(probs, k)  # [g, k], descending
    if k > 1 or cfg.moe_top1_renorm:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # each (token, slot)'s rank among the picks of its expert, slot-major:
    # all top-1 picks before any top-2 pick; masked tokens claim nothing
    onehot = F.one_hot(gate_idx, e).float() * mask[:, None, None]  # [g, k, E]
    slot_major = onehot.transpose(0, 1).reshape(k * g, e)
    pos = (torch.cumsum(slot_major, dim=0) - slot_major).reshape(k, g, e).transpose(0, 1)
    keep = (pos < c).float() * onehot  # overflow past the capacity is dropped

    # dispatch [g, E, C] (0/1) and combine (the gate where kept). A token
    # picks an expert at most once, so each sum over k has at most one
    # nonzero term: these equal JAX's einsums exactly.
    pos_onehot = F.one_hot(pos.long().clamp_max(c - 1), c).float()  # [g, k, E, C]
    dispatch = (keep[..., None] * pos_onehot).sum(1)
    combine = ((gate_vals[:, :, None] * keep)[..., None] * pos_onehot).sum(1)

    xin = torch.einsum("tec,td->ecd", dispatch.to(dt), x)  # [E, C, D]
    gate = torch.einsum("ecd,edf->ecf", xin, w_gate)
    up = torch.einsum("ecd,edf->ecf", xin, w_up)
    out = torch.einsum("ecf,efd->ecd", F.silu(gate) * up, w_down)
    y = torch.einsum("tec,ecd->td", combine.to(dt), out)  # [g, D]

    # load-balancing loss (Switch eq. 4) over the real tokens: E * sum_e f_e * P_e
    denom = mask.sum().clamp_min(1.0)
    me = (probs * mask[:, None]).sum(0) / denom
    ce = keep.sum(1).sum(0) / denom
    aux = (me * ce).sum() * e * cfg.moe_aux_loss_coef
    return y, aux


def moe_mlp(
    x: torch.Tensor,  # [T, D] tokens
    router_w,  # [D, E]
    w_gate,  # [E, D, F]
    w_up,  # [E, D, F]
    w_down,  # [E, F, D]
    cfg: ModelConfig,
    mask: Optional[torch.Tensor] = None,  # [T], 1 = real token
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ([T, D] output, scalar f32 load-balancing aux loss). T past the
    group size splits into equal groups; their aux values are averaged. The
    weights are read (dequantized, or cast) once for all groups."""
    t = x.shape[0]
    ws = [as_weight(w, x.dtype) for w in (router_w, w_gate, w_up, w_down)]
    mask = (torch.ones((t,), device=x.device) if mask is None
            else mask.to(device=x.device, dtype=torch.float32))
    g = _group_size(t)
    outs = [_moe_group(x[i:i + g], mask[i:i + g], *ws, cfg) for i in range(0, t, g)]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([y for y, _ in outs]),
            torch.stack([aux for _, aux in outs]).mean())


# logical axes of one layer's MoE leaves (ray_tpu/models/moe.py:144-149)
EXPERT_AXES = {
    "router": ("embed", "expert"),
    "w_gate": ("expert", "embed", "mlp"),
    "w_up": ("expert", "embed", "mlp"),
    "w_down": ("expert", "mlp", "embed"),
}


def expert_shapes(cfg: ModelConfig) -> dict:
    """One layer's MoE leaves, in place of the dense w_gate/w_up/w_down
    (init_expert_weights' shapes; llama.init draws them)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}


def expert_scales(cfg: ModelConfig) -> dict:
    """init_expert_weights' scales (ray_tpu/models/moe.py:130-141)."""
    s_in = cfg.d_model ** -0.5
    return {"router": s_in, "w_gate": s_in, "w_up": s_in,
            "w_down": (2 * cfg.n_layers * cfg.d_ff) ** -0.5}
