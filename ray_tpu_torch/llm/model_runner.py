"""Prefill/decode and speculative verify over a slot-based device-resident
KV cache (port of ray_tpu/llm/model_runner.py, slot layout). One layer body
runs a window of W tokens per slot: a decode step is W = 1, a speculative
verify W = k + 1. It is shared with the paged layout (llm/paged.py) through
a cache adapter, as in the JAX package. The n-gram proposer and the fused
propose -> verify -> accept burst run on the device with no host sync.

The cache is a static [L, slots, max_len, kv_heads, head_dim] tensor with a
per-slot ``lengths`` vector that masks attention and indexes the writes. Slots
are the continuous-batching unit: prefill fills one slot, decode advances all
slots in one step.

Unlike the JAX functions (pure, with donated buffers), these update the
DecodeState's cache and lengths IN PLACE: prefill writes the prompt's K/V
straight into its slot, and each decode step writes one position per slot.
The returned state is the same object. Random draws come from a
``torch.Generator``; greedy rows match the JAX package token for token.

Data parallelism (``data_parallel_size`` = N, a mesh whose "dp" axis holds
N replicas): each rank's cache holds its replica's max_num_seqs / N slots.
A batched call (``SlotOps`` here, ``paged.PagedOps``) runs the dp 1 function
on the replica's rows of the per-slot inputs and all-gathers its per-slot
outputs over "dp" (``over_replicas``), so every rank holds what the dp 1
call returns for all slots; a call for one slot runs on its replica only
(llm/tp_worker.py). No collective runs inside the model for dp.

Tensor parallelism: every function takes an optional ``mesh``. Under tp > 1
each rank calls it with its shard of the weights (``shard_params``, by
INFER_RULES) and a cache of its kv heads (``init_state(mesh=)``, the JAX
package's CACHE_SPEC over "tp"), and every rank gets the whole logits (see
models/llama.py), so sampling with equally seeded generators stays in step
across ranks.

Pipeline parallelism (``pipeline_parallel_size`` = P, a mesh whose "pp" axis
holds P stages): each stage holds n_layers / P layers
(``infer_rules_for_mesh`` cuts the stacked "layer" axis over "pp") and their
cache (``init_state(mesh=)``, the JAX package's CACHE_SPEC_PP). A prefill
runs stage by stage (models/llama.py). A batched call runs the replica's
slots through the stages in P microbatches (``_pp_schedule``; see the
pipeline section below), and every rank of the replica gets the same logits.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.config import ModelConfig
from ray_tpu_torch.ops.quant import as_weight
from ray_tpu_torch.parallel import pipeline
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.sharding import (INFER_RULES, AxisRules, all_gather, all_reduce,
                                             shard_pytree)

from . import sampling


class DecodeState(NamedTuple):
    """Device-resident serving state. lengths[s] = tokens cached in slot s."""

    k: torch.Tensor  # [L, slots, max_len, kv_heads, head_dim]
    v: torch.Tensor
    lengths: torch.Tensor  # [slots] int64


def init_state(cfg: ModelConfig, slots: int, max_len: int, device=None,
               dtype: Optional[torch.dtype] = None, mesh=None) -> DecodeState:
    """A zeroed slot cache; under tp > 1 it holds this rank's kv heads, under
    dp > 1 this replica's slots/dp slots (the JAX package's CACHE_SPEC), on a
    pipeline stage its n_layers / pp layers (CACHE_SPEC_PP)."""
    dev = resolve_device(device)
    dp = axis_size(mesh, "dp")
    if slots % dp:
        raise ValueError("max_num_seqs must be divisible by data_parallel_size")
    shape = (cfg.n_layers // axis_size(mesh, "pp"), slots // dp, max_len,
             cfg.n_kv_heads // axis_size(mesh, "tp"), cfg.head_dim)
    dtype = dtype or cfg.activation_dtype
    return DecodeState(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        lengths=torch.zeros((slots // dp,), dtype=torch.int64, device=dev),
    )


def infer_rules_for_mesh(mesh) -> AxisRules:
    """INFER_RULES, plus the stacked "layer" axis over "pp" when the mesh
    has pipeline stages (ray_tpu/llm/model_runner.py:65-70): a stage holds
    its layers, and the embedding, final norm and head stay whole on every
    stage."""
    if axis_size(mesh, "pp") > 1:
        return AxisRules({**INFER_RULES.rules, "layer": "pp"})
    return INFER_RULES


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's shard of a whole parameter dict (its own copies)."""
    llama.check_tensor_parallel(cfg, mesh)
    return shard_pytree(params, llama.param_axes(cfg), mesh, infer_rules_for_mesh(mesh))


# ------------------------------------------------------------------------- prefill

def prompt_mask(cfg: ModelConfig, s_pad: int, true_len: int, device):
    """[1, s_pad] f32, 1 at the prompt's real positions, for a MoE config:
    pad positions claim no expert capacity (ray_tpu/llm/model_runner.py:93-96).
    None for a dense config, which has nothing to mask."""
    if cfg.n_experts == 0:
        return None
    return (torch.arange(s_pad, device=device) < true_len).float()[None, :]


@torch.no_grad()
def prefill(
    params,
    state: DecodeState,
    tokens: torch.Tensor,  # [1, S_pad] int (padded to a bucket length)
    true_len: int,
    slot: int,
    cfg: ModelConfig,
    mesh=None,
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
    logits, _ = llama.forward(params, tokens, cfg, cache=view,
                              token_mask=prompt_mask(cfg, s_pad, true_len, tokens.device),
                              mesh=mesh, at=true_len - 1)
    state.lengths[slot] = true_len
    return state, logits[0, 0]


@torch.no_grad()
def prefill_detached(
    params,
    tokens: torch.Tensor,  # [1, S_pad] int
    true_len: int,
    cfg: ModelConfig,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill WITHOUT a decode state -> (k, v, last_logits [vocab] f32), k/v
    [L, 1, S_pad, KV, HD] in the activation dtype. The paged layout installs
    them into blocks; a chunk-assembled prompt goes to a slot via install_kv.
    Attention is causal self-attention over S_pad, the flash kernel's case on
    CUDA."""
    s_pad = tokens.shape[1]
    cache = llama.init_kv_cache(cfg, batch=1, max_len=s_pad, device=tokens.device, mesh=mesh)
    logits, cache = llama.forward(params, tokens, cfg, cache=cache,
                                  token_mask=prompt_mask(cfg, s_pad, true_len, tokens.device),
                                  mesh=mesh, at=true_len - 1)
    return cache.k, cache.v, logits[0, 0]


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

def _layer_core(x, lp, cfg: ModelConfig, pos, cache_rw, token_mask, mesh=None):
    """One layer over a window of W tokens for every slot, shared by decode
    (W = 1) and speculative verify (W = k + 1) in every cache layout.

    x [S,W,D]: query w of slot s sits at position pos[s, w] = lengths[s] + w
    and attends to the cache positions up to its own (causal within the
    window, the whole history before it). cache_rw(k_new [S,W,KV,HD], v_new)
    writes the window's K/V into its layout in place and returns per-slot
    full-history views (ck, cv) [S,max_len,KV,HD] for attention. token_mask
    [S,W] f32 (MoE only): an inactive slot's tokens claim no expert
    capacity; the S*W tokens route as one group, as in JAX. The head
    counts are the local weights' (this rank's under tp > 1), and the
    output projection and the MLP end in an all-reduce over "tp"."""
    dt = x.dtype
    s, wlen, _ = x.shape

    h = llama.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = torch.einsum("sld,dhk->slhk", h, as_weight(lp["wq"], dt))
    k = torch.einsum("sld,dhk->slhk", h, as_weight(lp["wk"], dt))
    vv = torch.einsum("sld,dhk->slhk", h, as_weight(lp["wv"], dt))
    nh, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    g = nh // kvh
    q = llama.rope(q, pos, cfg.rope_theta)
    k = llama.rope(k, pos, cfg.rope_theta)

    ck, cv = cache_rw(k, vv)
    max_len = ck.shape[1]

    qg = q.reshape(s, wlen, kvh, g, hd) * (hd ** -0.5)
    scores = torch.einsum("swkgd,stkd->swkgt", qg.float(), ck.float())
    valid = torch.arange(max_len, device=x.device)[None, None, :] <= pos[:, :, None]
    scores = scores.masked_fill(~valid[:, :, None, None, :], sampling.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("swkgt,stkd->swkgd", w, cv.float()).to(dt)
    o = o.reshape(s, wlen, nh, hd)
    x = x + all_reduce(torch.einsum("slhk,hkd->sld", o, as_weight(lp["wo"], dt)), mesh)

    down, _ = llama.mlp(llama.rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp, cfg, token_mask,
                        mesh)
    return x + down


def _window_positions(lengths, wlen: int):
    """[S, W] cache positions of a window: lengths[s] + w."""
    if wlen == 1:
        return lengths[:, None]
    return lengths[:, None] + torch.arange(wlen, device=lengths.device)[None, :]


def _slot_writes(lengths, wlen: int, max_len: int):
    """Where a window's K/V go in the slot layout: (rows [S,1], index [S,W],
    keep [S,W,1,1] or None) for positions lengths[s] + w.

    A verify window's position past max_len is dropped, as the JAX package's
    mode="drop" scatter drops it. It cannot simply be clamped: it would land
    on max_len - 1 beside the window's own write there, and which of two
    writes to one index wins is undefined. So it is folded onto pos -
    max_len, which no window position can be while W <= max_len, and writes
    back the value found there: every index is distinct and each write is
    well defined. A decode step (W = 1) writes at lengths[s] < max_len,
    which the engine keeps for every slot, with no mask (keep None): the
    mask's two extra launches per cache a layer would land on the host-bound
    decode step."""
    rows = torch.arange(lengths.shape[0], device=lengths.device)[:, None]
    pos = _window_positions(lengths, wlen)
    if wlen == 1:
        return rows, pos, None
    return rows, pos % max_len, (pos < max_len)[:, :, None, None]


def _slot_rw(ck, cv, writes):
    """The slot layout's cache adapter: ck/cv [S,max_len,KV,HD], the
    window's K/V written where _slot_writes says."""
    rows, idx, keep = writes

    def cache_rw(k_new, v_new):
        for c, new in ((ck, k_new), (cv, v_new)):
            new = new.to(c.dtype)
            c[rows, idx] = new if keep is None else torch.where(keep, new, c[rows, idx])
        return ck, cv

    return cache_rw


def _window_layers(params, x, cfg: ModelConfig, pos, layer_rw, token_mask, mesh=None):
    """This rank's layers (all of them, or a pipeline stage's) over the
    window's hidden states x [S,W,D] at positions pos [S,W]."""
    for i in range(llama.local_layers(params)):
        x = _layer_core(x, llama.layer_params(params, i), cfg, pos, layer_rw(i), token_mask,
                        mesh)
    return x


def _forward_window(params, window, cfg: ModelConfig, lengths, layer_rw, active, mesh=None,
                    layers_pass=None):
    """The model over a window of tokens [S,W] per slot in any cache layout
    (layer_rw(i) is layer i's cache adapter) -> logits [S,W,vocab] f32.
    Lengths are not advanced. A draft copied from the prompt may hold an
    out-of-vocabulary id: the lookup clamps it as JAX's gather does, and the
    greedy accept then rejects it (an argmax is always in the vocabulary).
    An inactive slot's window claims no MoE expert capacity (JAX masks a
    decode step by `active` and a verify window by `active` repeated W
    times, not by the draft length). `layers_pass(window)` -> x [S,W,D]
    replaces the embedding and the layer loop (the pipeline schedule runs
    its own: _pp_layers)."""
    if layers_pass is not None:
        x = layers_pass(window)
    else:
        x = llama._embed_lookup(params["embed"], window, cfg.activation_dtype, mesh)  # [S,W,D]
        token_mask = None
        if cfg.n_experts > 0:
            token_mask = active.float()[:, None].expand(window.shape)
        x = _window_layers(params, x, cfg, _window_positions(lengths, window.shape[1]),
                           layer_rw, token_mask, mesh)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return llama.logits_of(x, params, cfg, mesh)


@torch.no_grad()
def decode_step(
    params,
    state: DecodeState,
    tokens: torch.Tensor,  # [slots] int — last sampled token per slot
    active: torch.Tensor,  # [slots] bool — inactive slots compute but don't advance
    cfg: ModelConfig,
    mesh=None,
) -> Tuple[DecodeState, torch.Tensor]:
    """One decode step for every slot -> (state, logits [slots, vocab] f32).

    Inactive slots still flow through the matmuls, and their cache write lands
    at lengths[s] of a slot whose contents the next prefill overwrites; their
    length does not advance. Cache and lengths are updated in place. On a
    pipeline stage the layers run through the stages (_pp_slot_layers)."""
    writes = _slot_writes(state.lengths, 1, state.k.shape[2])
    logits = _decode_layers(params, tokens, active, cfg, state.lengths,
                            lambda i: _slot_rw(state.k[i], state.v[i], writes), mesh,
                            _pp_slot_layers(params, state, cfg, mesh))
    return state, logits


def _decode_layers(params, tokens, active, cfg: ModelConfig, lengths, layer_rw, mesh=None,
                   layers_pass=None):
    """A decode step's model pass over any cache layout: layer_rw(i) is layer
    i's cache adapter (or `layers_pass`, see _forward_window). Advances the
    active slots' lengths in place; returns logits [slots, vocab] f32."""
    logits = _forward_window(params, tokens[:, None], cfg, lengths, layer_rw, active,
                             mesh, layers_pass)[:, 0]
    lengths.add_(active.to(lengths.dtype))
    return logits


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
    mesh=None,
) -> Tuple[DecodeState, torch.Tensor]:
    """n_steps decode+sample steps with no host sync in between (vLLM
    multi-step scheduling) -> (state, tokens [n_steps, slots] on the device).

    Step t treats slot s as inactive once t >= steps_left[s], so a slot near
    its max_tokens/KV budget stops at its own limit without capping the burst
    for everyone. Only the first steps_left[s] rows of the result are
    meaningful for slot s."""
    return _burst(lambda st, toks, act: decode_step(params, st, toks, act, cfg, mesh), state,
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


# --------------------------------------------------------------- speculative decoding

def spec_accept(window, greedy, draft_len, active, temperature, top_p, top_k, logits0,
                generator=None):
    """Shared accept logic: the longest draft prefix that matches the argmax,
    plus one bonus token; temperature > 0 slots (no drafts) get a SAMPLED
    first token. -> (tokens [S,W] (greedy, updated in place), n_acc [S],
    advance [S]: n_acc + 1 for active slots, else 0)."""
    tok0 = sampling.sample(logits0, temperature, top_p, top_k, generator)
    greedy[:, 0] = torch.where(temperature > 0, tok0, greedy[:, 0])
    wlen = window.shape[1]
    idx = torch.arange(wlen - 1, device=window.device)[None, :]
    match = (window[:, 1:] == greedy[:, :-1]) & (idx < draft_len[:, None])
    n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
    advance = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    return greedy, n_acc, advance


def spec_driver(params, window, draft_len, active, cfg: ModelConfig, lengths, layer_rw,
                temperature, top_p, top_k, generator=None, mesh=None, layers_pass=None):
    """The speculative verify pipeline shared by both layouts (embed ->
    layers -> norm -> head -> accept); layer_rw(i) is layer i's window
    adapter, or `layers_pass(window)` -> x replaces the embedding and the
    layer loop (the pipeline schedule's seam, as in JAX). Advances lengths
    by n_acc + 1 for active slots in place.
    -> (tokens [S,W], n_acc [S], logits [S,W,vocab] f32)."""
    logits = _forward_window(params, window, cfg, lengths, layer_rw, active, mesh,
                             layers_pass)
    greedy = torch.argmax(logits, dim=-1)
    greedy, n_acc, advance = spec_accept(window, greedy, draft_len, active, temperature,
                                         top_p, top_k, logits[:, 0], generator)
    lengths.add_(advance)
    return greedy, n_acc, logits


@torch.no_grad()
def spec_verify_step(
    params,
    state: DecodeState,
    window: torch.Tensor,  # [S,W] int — [last_token, draft_1..draft_k] (0-padded)
    draft_len: torch.Tensor,  # [S] int — valid drafts per slot (<= W-1)
    active: torch.Tensor,  # [S] bool
    cfg: ModelConfig,
    temperature: torch.Tensor,  # [S] f32
    top_p: torch.Tensor,  # [S] f32
    top_k: torch.Tensor,  # [S] int
    generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
    mesh=None,
):
    """Speculative verify (reference: vLLM ngram/prompt-lookup speculative
    decoding): ONE forward over the W-token window scores every draft; greedy
    accept = longest prefix where draft[i] == argmax(logits[i-1]).

    Returns (state, out_tokens [S,W], n_accepted [S]), and the window's logits
    [S,W,vocab] f32 last with return_logits: out_tokens[s, :n+1] are this
    step's emitted tokens (n accepted drafts + 1 bonus/correction); lengths
    advance by n+1 for active slots, in place. Writes past max_len are
    dropped. On a pipeline stage the window is the microbatch payload
    through the stages (_pp_slot_layers)."""
    writes = _slot_writes(state.lengths, window.shape[1], state.k.shape[2])
    toks, n_acc, logits = spec_driver(
        params, window, draft_len, active, cfg, state.lengths,
        lambda i: _slot_rw(state.k[i], state.v[i], writes), temperature, top_p, top_k,
        generator, mesh, _pp_slot_layers(params, state, cfg, mesh))
    return (state, toks, n_acc, logits) if return_logits else (state, toks, n_acc)


def _gather_rows(hist, start, width: int):
    """hist[s, start[s] : start[s] + width] for every row s, start clamped to
    [0, L - width] as lax.dynamic_slice clamps it: the slice is moved back so
    that it fits, never read past the row."""
    start = start.clamp(0, hist.shape[1] - width)
    idx = start[:, None] + torch.arange(width, device=hist.device)[None, :]
    return torch.gather(hist, 1, idx)


def propose_ngram_device(hist, hlen, last, k: int, nmax: int):
    """On-device prompt-lookup proposal (the engine's host _propose_ngram,
    with no host sync, so it runs inside a fused burst): for each slot, find
    the most recent earlier occurrence of the trailing n-gram (longest n <=
    nmax first) in the slot's token history and propose the k tokens that
    followed it.

    hist [S,L] int (prompt + emitted tokens), hlen [S] valid length,
    last [S] == hist[hlen-1]. Returns (window [S,k+1], draft_len [S])."""
    s_n, width = hist.shape
    dev = hist.device
    best_start = torch.zeros((s_n,), dtype=torch.long, device=dev)
    best_n = torch.zeros((s_n,), dtype=torch.long, device=dev)
    for n in range(nmax, 0, -1):  # longest n wins
        tail = _gather_rows(hist, hlen - n, n)  # [S,n]
        eq = torch.ones((s_n, width - n), dtype=torch.bool, device=dev)
        for i in range(n):
            eq &= hist[:, i:width - n + i] == tail[:, i:i + 1]
        j = torch.arange(width - n, device=dev)[None, :]
        eq &= j < (hlen - n)[:, None]  # strictly before the tail's own start
        start = torch.where(eq, j, torch.full_like(j, -1)).amax(dim=1)  # most recent
        # a match whose continuation is empty (it butts against the tail) is
        # useless: fall through to a shorter n, as the host proposer does
        found = eq.any(dim=1) & (hlen - (start + n) > 0)
        pick = found & (best_n == 0)
        best_start = torch.where(pick, start, best_start)
        best_n = torch.where(pick, torch.full_like(best_n, n), best_n)
    drafts = _gather_rows(hist, torch.clamp(best_start + best_n, max=width - k), k)
    avail = (hlen - (best_start + best_n)).clamp(0, k)
    draft_len = torch.where(best_n > 0, avail, torch.zeros_like(avail))
    keep = torch.arange(k, device=dev)[None, :] < draft_len[:, None]
    window = torch.cat([last.long()[:, None], torch.where(keep, drafts, 0)], dim=1)
    return window, draft_len


def spec_multi_impl(hist, hlen, active, temperature, m: int, k: int, nmax: int, proposer,
                    verify):
    """Layout-generic fused speculation: m propose -> verify -> accept windows
    chained on the device with no host sync. verify(window, draft_len) ->
    (tokens [S,W], n_acc [S]) is the layout's verify step on its state.
    Returns (toks_m [m,S,k+1], acc_m [m,S], drafted_m [m,S])."""
    h, hl = hist.clone(), hlen.clone()
    rows = torch.arange(h.shape[0], device=h.device)
    last = h[rows, (hl - 1).clamp_min(0)]
    toks_m, acc_m, drafted_m = [], [], []
    for _ in range(m):
        window, draft_len = proposer(h, hl, last, k, nmax)
        draft_len = torch.where(temperature > 0, torch.zeros_like(draft_len), draft_len)
        greedy, n_acc = verify(window, draft_len)
        adv = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
        for t in range(k + 1):  # this window's emitted tokens into the history
            pos = (hl + t).clamp(0, h.shape[1] - 1)
            h[rows, pos] = torch.where(t < adv, greedy[:, t], h[rows, pos])
        last = torch.where(adv > 0, greedy[rows, (adv - 1).clamp_min(0)], last)
        hl = hl + adv
        toks_m.append(greedy)
        acc_m.append(n_acc)
        drafted_m.append(draft_len)
    return torch.stack(toks_m), torch.stack(acc_m), torch.stack(drafted_m)


@torch.no_grad()
def spec_multi(
    params,
    state: DecodeState,
    hist: torch.Tensor,  # [S, width] int — prompt + emitted tokens per slot
    hlen: torch.Tensor,  # [S] int — valid history length
    active: torch.Tensor,  # [S] bool — fixed for the whole burst
    cfg: ModelConfig,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    m: int,
    k: int,
    nmax: int,
    propose_fn=None,  # test seam: (hist, hlen, last, k, nmax) -> (window, draft_len)
    generator: Optional[torch.Generator] = None,
    mesh=None,
):
    """m fused speculative windows per host sync: propose (on-device n-gram
    lookup) -> verify forward -> accept, m times, composing vLLM's
    multi-step scheduling with prompt-lookup speculation. Per sync the
    engine emits between m and m*(k+1) tokens. Greedy slots speculate;
    temperature > 0 slots ride along sampling one token per window.

    Returns (state, toks_m [m,S,k+1], acc_m [m,S], drafted_m [m,S])."""
    return (state, *spec_multi_impl(
        hist, hlen, active, temperature, m, k, nmax, propose_fn or propose_ngram_device,
        lambda window, draft_len: spec_verify_step(
            params, state, window, draft_len, active, cfg, temperature, top_p, top_k,
            generator, mesh=mesh)[1:]))


# ------------------------------------------------------------ data parallelism

def slot_replica(slot: int, slots_per: int) -> Tuple[int, int]:
    """(replica, local slot) of a global slot under data parallelism:
    replica r owns slots r * slots_per ... (r + 1) * slots_per - 1 (the JAX
    package's P("dp") cut of the slot axis). The one rule that the block
    manager, the engine, the ShardRunner and the _dp functions share."""
    return divmod(int(slot), slots_per)


def replica_slots(replica: int, slots_per: int) -> slice:
    """The global slots `replica` owns (slot_replica's inverse)."""
    return slice(replica * slots_per, (replica + 1) * slots_per)


def replica_rows(mesh, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This data-parallel replica's rows of each per-slot [S, ...] tensor."""
    rows = replica_slots(axis_index(mesh, "dp"), xs[0].shape[0] // axis_size(mesh, "dp"))
    return tuple(x[rows] for x in xs)


def gather_replicas(mesh, outs: Sequence[torch.Tensor], dims: Sequence[int]) -> List[torch.Tensor]:
    """Per-slot outputs of every replica joined in replica order along each
    one's slot dim (`dims`), in ONE all-gather over "dp" (the outputs share
    a dtype and ride packed side by side)."""
    flat = [o.movedim(d, 0) for o, d in zip(outs, dims)]
    packed = torch.cat([f.reshape(f.shape[0], -1) for f in flat], dim=1)
    whole = all_gather(packed, mesh, "dp", dim=0)
    got, at = [], 0
    for f, d in zip(flat, dims):
        width = math.prod(f.shape[1:])
        got.append(whole[:, at:at + width].reshape(-1, *f.shape[1:]).movedim(0, d))
        at += width
    return got


def over_replicas(mesh, fn: Callable, per_slot: Sequence[torch.Tensor], dims: Sequence[int],
                  idle: Optional[Callable] = None) -> List[torch.Tensor]:
    """A batched call under data parallelism: fn(*rows) on this replica's rows
    of each per-slot input (per_slot[1] is the active mask) -> its per-slot
    outputs, gathered over the replicas (gather_replicas), so every rank
    holds the [.., S] outputs of the dp 1 call. With `idle`, a replica with
    no active row runs idle(*rows) instead of the model (its tokens
    unchanged, as where(active, next, tokens) keeps them) and still joins
    the gather. At dp 1, fn on the inputs themselves."""
    if axis_size(mesh, "dp") == 1:
        return list(fn(*per_slot))
    rows = replica_rows(mesh, *per_slot)
    outs = idle(*rows) if idle is not None and not bool(rows[1].any()) else fn(*rows)
    return gather_replicas(mesh, outs, dims)


def _idle_burst(n_steps: int):
    return lambda tokens, *_: (tokens.long()[None].expand(n_steps, -1),)


def _idle_verify(window, draft_len, *_):
    return window.long(), torch.zeros_like(draft_len)


def _idle_multi(m: int, k: int):
    def idle(hist, hlen):
        rows = torch.arange(hist.shape[0], device=hist.device)
        last = hist[rows, (hlen - 1).clamp_min(0)].long()
        zeros = torch.zeros((m, hist.shape[0]), dtype=torch.long, device=hist.device)
        return last[None, :, None].expand(m, -1, k + 1), zeros, zeros

    return idle


# ------------------------------------------------------------ pipeline parallelism
#
# pipeline_parallel_size = P (ray_tpu/llm/model_runner.py:571-716): a batched
# call splits the replica's slots into P microbatches of slots / (P * dp).
# Stage s takes them in turn: from the embedding (s = 0) or from stage s - 1,
# through its layers on the microbatch's cache rows, on to stage s + 1
# (parallel/pipeline.py); the last stage's outputs reach every stage of the
# replica by one broadcast over "pp", and every rank runs the final norm and
# the head on them. JAX's tick loop runs M + P - 1 ticks on every stage, and
# a stage's fill and drain ticks compute on a clipped microbatch whose writes
# it discards (slot layout) or sends to the scratch block (paged). A process
# per stage waits for its input instead: no bubble tick is computed, and the
# cache holds the same values. A mixture-of-experts model is not served
# under pp (its experts would route a microbatch's tokens as one group):
# ROADMAP A6.

def _pp_schedule(x_of, step_mb, shape, dtype, device, mesh) -> torch.Tensor:
    """The replica's rows through the stages in P microbatches:
    x_of(rows) -> stage 0's input [smb, W, D] (rows a slice of the replica's
    slots), step_mb(h, rows) -> this stage's output for those rows. Returns
    the last stage's outputs [S, W, D] (`shape`) on every stage."""
    pp, stage = axis_size(mesh, "pp"), axis_index(mesh, "pp")
    if shape[0] % pp:  # LLMConfig refuses such an engine; a direct call is refused here
        raise ValueError(f"a replica's {shape[0]} slots do not split into {pp} microbatches")
    smb = shape[0] // pp
    outs = []
    for j in range(pp):
        rows = slice(j * smb, (j + 1) * smb)
        if stage == 0:
            h = x_of(rows)
        else:
            h = pipeline.recv_from_prev((smb,) + tuple(shape[1:]), dtype, device, mesh)
        h = step_mb(h, rows)
        if stage < pp - 1:
            pipeline.send_to_next(h, mesh)
        else:
            outs.append(h)
    out = torch.cat(outs) if stage == pp - 1 else torch.empty(shape, dtype=dtype,
                                                             device=device)
    return pipeline.from_last_stage(out, mesh)


def _pp_layers(params, window, cfg: ModelConfig, lengths, mb_rw, mesh):
    """The layers_pass of a pipeline stage for a window [S,W] of the
    replica's slots: mb_rw(rows)(i) is local layer i's cache adapter for a
    microbatch's rows -> the last stage's hidden states [S,W,D]."""
    if cfg.n_experts > 0:
        raise NotImplementedError("a mixture-of-experts model under pipeline parallelism: "
                                  "ROADMAP A6")
    s, wlen = window.shape
    pos = _window_positions(lengths, wlen)
    return _pp_schedule(
        lambda rows: llama._embed_lookup(params["embed"], window[rows], cfg.activation_dtype,
                                         mesh),
        lambda h, rows: _window_layers(params, h, cfg, pos[rows], mb_rw(rows), None, mesh),
        (s, wlen, cfg.d_model), cfg.activation_dtype, window.device, mesh)


def _pp_slot_layers(params, state: DecodeState, cfg: ModelConfig, mesh):
    """The slot layout's layers_pass through the schedule (JAX's
    _pp_slot_layers): a microbatch writes its own slots' rows of this
    stage's cache. None without pipeline stages."""
    if axis_size(mesh, "pp") == 1:
        return None

    def layers_pass(window):
        wlen, max_len = window.shape[1], state.k.shape[2]

        def mb_rw(rows):
            writes = _slot_writes(state.lengths[rows], wlen, max_len)
            return lambda i: _slot_rw(state.k[i, rows], state.v[i, rows], writes)

        return _pp_layers(params, window, cfg, state.lengths, mb_rw, mesh)

    return layers_pass


@torch.no_grad()
def decode_step_pp(params, state: DecodeState, tokens, active, cfg: ModelConfig, mesh):
    """One decode step of every slot [S] with the layers and the cache
    split over "pp" stages, each replica's slots microbatched through them
    (ray_tpu/llm/model_runner.py:680-716) -> (state, logits [S, vocab] of
    every replica, on every rank): the engine's call, SlotOps.decode_step."""
    return SlotOps(cfg, mesh).decode_step(params, state, tokens, active)


@torch.no_grad()
def spec_verify_step_pp(params, state: DecodeState, window, draft_len, active,
                        cfg: ModelConfig, temperature, top_p, top_k, generator=None, mesh=None):
    """Speculative verify through the stages (ray_tpu/llm/model_runner.py:
    394-418): the window [S, W] is the microbatch payload -> (state, tokens
    [S, W], n_accepted [S]) of every replica: the engine's call,
    SlotOps.spec_verify."""
    return SlotOps(cfg, mesh).spec_verify(params, state, window, draft_len, active,
                                          temperature, top_p, top_k, generator)


class SlotOps:
    """Engine-facing batched calls of the slot layout for one cache (the
    paged layout's are paged.PagedOps): the functions above on this rank's
    shard (through the stages on a pipeline stage), and under dp > 1 on this
    replica's slots, their per-slot outputs gathered over "dp"
    (over_replicas)."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh

    def decode_step(self, params, state, tokens, active):
        """-> (state, logits [S, vocab]), every replica's rows."""
        (logits,) = over_replicas(
            self.mesh, lambda t, a: (decode_step(params, state, t, a, self.cfg, self.mesh)[1],),
            (tokens, active), (0,))
        return state, logits

    def decode_multi(self, params, state, tokens, active, n_steps, temperature, top_p,
                     top_k, steps_left, generator=None):
        (toks,) = over_replicas(
            self.mesh, lambda t, a, tt, p, k, sl: decode_multi(
                params, state, t, a, self.cfg, n_steps, tt, p, k, sl, generator,
                self.mesh)[1:],
            (tokens, active, temperature, top_p, top_k, steps_left), (1,),
            _idle_burst(n_steps))
        return state, toks

    def spec_verify(self, params, state, window, draft_len, active, temperature, top_p,
                    top_k, generator=None):
        toks, n_acc = over_replicas(
            self.mesh, lambda w, a, d, tt, p, k: spec_verify_step(
                params, state, w, d, a, self.cfg, tt, p, k, generator, mesh=self.mesh)[1:],
            (window, active, draft_len, temperature, top_p, top_k), (0, 0),
            lambda w, a, d, *_: _idle_verify(w, d))
        return state, toks, n_acc

    def spec_multi(self, params, state, hist, hlen, active, temperature, top_p, top_k, m,
                   k, nmax, generator=None):
        out = over_replicas(
            self.mesh, lambda h, a, hl, tt, p, kk: spec_multi(
                params, state, h, hl, a, self.cfg, tt, p, kk, m, k, nmax,
                generator=generator, mesh=self.mesh)[1:],
            (hist, active, hlen, temperature, top_p, top_k), (1, 1, 1),
            lambda h, a, hl, *_: _idle_multi(m, k)(h, hl))
        return (state, *out)
