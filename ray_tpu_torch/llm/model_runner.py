"""Prefill/decode over a slot-based device-resident KV cache
(port of ray_tpu/llm/model_runner.py, slot layout). The layer body of a
decode step is shared with the paged layout (llm/paged.py) through a cache
adapter, as in the JAX package.

The cache is a static [L, slots, max_len, kv_heads, head_dim] tensor with a
per-slot ``lengths`` vector that masks attention and indexes the writes. Slots
are the continuous-batching unit: prefill fills one slot, decode advances all
slots in one step.

Unlike the JAX functions (pure, with donated buffers), these update the
DecodeState's cache and lengths IN PLACE: prefill writes the prompt's K/V
straight into its slot, and each decode step writes one position per slot.
The returned state is the same object.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.config import ModelConfig

from . import sampling


class DecodeState(NamedTuple):
    """Device-resident serving state. lengths[s] = tokens cached in slot s."""

    k: torch.Tensor  # [L, slots, max_len, kv_heads, head_dim]
    v: torch.Tensor
    lengths: torch.Tensor  # [slots] int64


def init_state(cfg: ModelConfig, slots: int, max_len: int, device=None,
               dtype: Optional[torch.dtype] = None) -> DecodeState:
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.activation_dtype
    return DecodeState(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int64, device=dev),
    )


# ------------------------------------------------------------------------- prefill

@torch.no_grad()
def prefill(
    params,
    state: DecodeState,
    tokens: torch.Tensor,  # [1, S_pad] int (padded to a bucket length)
    true_len: int,
    slot: int,
    cfg: ModelConfig,
) -> Tuple[DecodeState, torch.Tensor]:
    """Run the prompt through the model, write its KV into `slot` (in place),
    return (state, logits at the last real token [vocab] f32).

    The forward runs over a fresh cache of S_pad positions, as in the JAX
    package; here that cache is the slot's own first S_pad positions, so
    attention is causal self-attention over S_pad (the flash kernel's case on
    CUDA) and no copy is needed afterwards."""
    s_pad = tokens.shape[1]
    if s_pad > state.k.shape[2]:
        raise ValueError(f"prompt bucket {s_pad} exceeds the slot length {state.k.shape[2]}")
    view = llama.KVCache(k=state.k[:, slot:slot + 1, :s_pad],
                         v=state.v[:, slot:slot + 1, :s_pad], length=0)
    logits, _ = llama.forward(params, tokens, cfg, cache=view)
    state.lengths[slot] = true_len
    return state, logits[0, true_len - 1].float()


@torch.no_grad()
def prefill_detached(
    params,
    tokens: torch.Tensor,  # [1, S_pad] int
    true_len: int,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill WITHOUT a decode state -> (k, v, last_logits [vocab] f32), k/v
    [L, 1, S_pad, KV, HD] in the activation dtype. The paged layout installs
    them into blocks; a chunk-assembled prompt goes to a slot via install_kv.
    Attention is causal self-attention over S_pad, the flash kernel's case on
    CUDA."""
    cache = llama.init_kv_cache(cfg, batch=1, max_len=tokens.shape[1], device=tokens.device)
    logits, cache = llama.forward(params, tokens, cfg, cache=cache)
    return cache.k, cache.v, logits[0, true_len - 1].float()


@torch.no_grad()
def install_kv(state: DecodeState, k: torch.Tensor, v: torch.Tensor, true_len: int,
               slot: int) -> DecodeState:
    """Copy prefill KV [L, 1, S_pad, KV, HD] into `slot` (in place)."""
    s_pad = k.shape[2]
    state.k[:, slot, :s_pad] = k[:, 0].to(state.k.dtype)
    state.v[:, slot, :s_pad] = v[:, 0].to(state.v.dtype)
    state.lengths[slot] = true_len
    return state


# -------------------------------------------------------------------------- decode

def _decode_core(x, lp, cfg: ModelConfig, lengths, cache_rw):
    """One layer's single-token decode for every slot, shared by every cache
    layout. x [S,1,D]. cache_rw(k_new [S,KV,HD], v_new) writes this step's K/V
    into its layout in place and returns per-slot full-history views
    (ck, cv) [S,max_len,KV,HD] for attention."""
    dt = x.dtype
    s = x.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kvh
    pos = lengths[:, None]  # [S,1] — the new token's position

    h = llama.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = torch.einsum("sld,dhk->slhk", h, lp["wq"].to(dt))
    k = torch.einsum("sld,dhk->slhk", h, lp["wk"].to(dt))
    vv = torch.einsum("sld,dhk->slhk", h, lp["wv"].to(dt))
    q = llama.rope(q, pos, cfg.rope_theta)
    k = llama.rope(k, pos, cfg.rope_theta)

    ck, cv = cache_rw(k[:, 0], vv[:, 0])
    max_len = ck.shape[1]

    qg = q[:, 0].reshape(s, kvh, g, hd) * (hd ** -0.5)
    scores = torch.einsum("skgd,stkd->skgt", qg.float(), ck.float())
    valid = (torch.arange(max_len, device=x.device)[None, :]
             <= lengths[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, sampling.NEG_INF))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("skgt,stkd->skgd", w, cv.float()).to(dt)
    o = o.reshape(s, 1, cfg.n_heads, hd)
    x = x + torch.einsum("slhk,hkd->sld", o, lp["wo"].to(dt))

    h = llama.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = torch.einsum("sld,df->slf", h, lp["w_gate"].to(dt))
    up = torch.einsum("sld,df->slf", h, lp["w_up"].to(dt))
    down = torch.einsum("slf,fd->sld", F.silu(gate) * up, lp["w_down"].to(dt))
    return x + down


def _slot_rw(ck, cv, lengths):
    """The slot layout's cache adapter: ck/cv [S,max_len,KV,HD], this step's
    K/V written at position lengths[s]."""
    rows = torch.arange(ck.shape[0], device=ck.device)

    def cache_rw(k_new, v_new):
        ck[rows, lengths] = k_new.to(ck.dtype)
        cv[rows, lengths] = v_new.to(cv.dtype)
        return ck, cv

    return cache_rw


@torch.no_grad()
def decode_step(
    params,
    state: DecodeState,
    tokens: torch.Tensor,  # [slots] int — last sampled token per slot
    active: torch.Tensor,  # [slots] bool — inactive slots compute but don't advance
    cfg: ModelConfig,
) -> Tuple[DecodeState, torch.Tensor]:
    """One decode step for every slot -> (state, logits [slots, vocab] f32).

    Inactive slots still flow through the matmuls, and their cache write lands
    at lengths[s] of a slot whose contents the next prefill overwrites; their
    length does not advance. Cache and lengths are updated in place."""
    logits = _decode_layers(params, tokens, active, cfg, state.lengths,
                            lambda i: _slot_rw(state.k[i], state.v[i], state.lengths))
    return state, logits


def _decode_layers(params, tokens, active, cfg: ModelConfig, lengths, layer_rw):
    """A decode step's model pass over any cache layout: layer_rw(i) is layer
    i's cache adapter. Advances the active slots' lengths in place; returns
    logits [slots, vocab] f32."""
    x = params["embed"][tokens[:, None]].to(cfg.activation_dtype)  # [S,1,D]
    for i in range(cfg.n_layers):
        x = _decode_core(x, llama.layer_params(params, i), cfg, lengths, layer_rw(i))
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("sld,dv->slv", x, llama.lm_head(params, cfg))[:, 0]
    lengths.add_(active.to(lengths.dtype))
    return logits.float()


@torch.no_grad()
def decode_multi(
    params,
    state: DecodeState,
    tokens: torch.Tensor,  # [slots] int — last sampled token per slot
    active: torch.Tensor,  # [slots] bool — fixed for the whole burst
    cfg: ModelConfig,
    n_steps: int,
    temperature: torch.Tensor,  # [slots] f32
    top_p: torch.Tensor,  # [slots] f32
    top_k: torch.Tensor,  # [slots] int
    steps_left: torch.Tensor,  # [slots] int — per-slot step budget within the burst
    generator: Optional[torch.Generator] = None,
) -> Tuple[DecodeState, torch.Tensor]:
    """n_steps decode+sample steps with no host sync in between (vLLM
    multi-step scheduling) -> (state, tokens [n_steps, slots] on the device).

    Step t treats slot s as inactive once t >= steps_left[s], so a slot near
    its max_tokens/KV budget stops at its own limit without capping the burst
    for everyone. Only the first steps_left[s] rows of the result are
    meaningful for slot s."""
    return _burst(lambda st, toks, act: decode_step(params, st, toks, act, cfg), state,
                  tokens, active, n_steps, temperature, top_p, top_k, steps_left, generator)


def _burst(step, state, tokens, active, n_steps, temperature, top_p, top_k, steps_left,
           generator):
    """The fused burst over any layout's step(state, tokens, active) ->
    (state, logits)."""
    toks = tokens.long()
    out = []
    for t in range(n_steps):
        act_t = active & (t < steps_left)
        state, logits = step(state, toks, act_t)
        nxt = sampling.sample(logits, temperature, top_p, top_k, generator)
        toks = torch.where(act_t, nxt, toks)
        out.append(toks)
    return state, torch.stack(out)


@torch.no_grad()
def sample_tokens(logits, temperature, top_p, top_k, generator=None):
    return sampling.sample(logits, temperature, top_p, top_k, generator)
