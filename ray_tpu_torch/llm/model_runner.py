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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.config import ModelConfig
from ray_tpu_torch.ops.quant import as_weight

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

def _layer_core(x, lp, cfg: ModelConfig, pos, cache_rw):
    """One layer over a window of W tokens for every slot, shared by decode
    (W = 1) and speculative verify (W = k + 1) in every cache layout.

    x [S,W,D]: query w of slot s sits at position pos[s, w] = lengths[s] + w
    and attends to the cache positions up to its own (causal within the
    window, the whole history before it). cache_rw(k_new [S,W,KV,HD], v_new)
    writes the window's K/V into its layout in place and returns per-slot
    full-history views (ck, cv) [S,max_len,KV,HD] for attention."""
    dt = x.dtype
    s, wlen, _ = x.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kvh

    h = llama.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = torch.einsum("sld,dhk->slhk", h, as_weight(lp["wq"], dt))
    k = torch.einsum("sld,dhk->slhk", h, as_weight(lp["wk"], dt))
    vv = torch.einsum("sld,dhk->slhk", h, as_weight(lp["wv"], dt))
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
    o = o.reshape(s, wlen, cfg.n_heads, hd)
    x = x + torch.einsum("slhk,hkd->sld", o, as_weight(lp["wo"], dt))

    h = llama.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = torch.einsum("sld,df->slf", h, as_weight(lp["w_gate"], dt))
    up = torch.einsum("sld,df->slf", h, as_weight(lp["w_up"], dt))
    down = torch.einsum("slf,fd->sld", F.silu(gate) * up, as_weight(lp["w_down"], dt))
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


def _forward_window(params, window, cfg: ModelConfig, lengths, layer_rw):
    """The model over a window of tokens [S,W] per slot in any cache layout
    (layer_rw(i) is layer i's cache adapter) -> logits [S,W,vocab] f32.
    Lengths are not advanced. A draft copied from the prompt may hold an
    out-of-vocabulary id: the lookup clamps it as JAX's gather does, and the
    greedy accept then rejects it (an argmax is always in the vocabulary)."""
    x = llama._embed_lookup(params["embed"], window, cfg.activation_dtype)  # [S,W,D]
    pos = _window_positions(lengths, window.shape[1])
    for i in range(cfg.n_layers):
        x = _layer_core(x, llama.layer_params(params, i), cfg, pos, layer_rw(i))
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("sld,dv->slv", x, llama.lm_head(params, cfg)).float()


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
    writes = _slot_writes(state.lengths, 1, state.k.shape[2])
    logits = _decode_layers(params, tokens, active, cfg, state.lengths,
                            lambda i: _slot_rw(state.k[i], state.v[i], writes))
    return state, logits


def _decode_layers(params, tokens, active, cfg: ModelConfig, lengths, layer_rw):
    """A decode step's model pass over any cache layout: layer_rw(i) is layer
    i's cache adapter. Advances the active slots' lengths in place; returns
    logits [slots, vocab] f32."""
    logits = _forward_window(params, tokens[:, None], cfg, lengths, layer_rw)[:, 0]
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
                temperature, top_p, top_k, generator=None):
    """The speculative verify pipeline shared by both layouts (embed ->
    layers -> norm -> head -> accept); layer_rw(i) is layer i's window
    adapter. Advances lengths by n_acc + 1 for active slots in place.
    -> (tokens [S,W], n_acc [S], logits [S,W,vocab] f32)."""
    logits = _forward_window(params, window, cfg, lengths, layer_rw)
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
):
    """Speculative verify (reference: vLLM ngram/prompt-lookup speculative
    decoding): ONE forward over the W-token window scores every draft; greedy
    accept = longest prefix where draft[i] == argmax(logits[i-1]).

    Returns (state, out_tokens [S,W], n_accepted [S]), and the window's logits
    [S,W,vocab] f32 last with return_logits: out_tokens[s, :n+1] are this
    step's emitted tokens (n accepted drafts + 1 bonus/correction); lengths
    advance by n+1 for active slots, in place. Writes past max_len are
    dropped."""
    writes = _slot_writes(state.lengths, window.shape[1], state.k.shape[2])
    toks, n_acc, logits = spec_driver(
        params, window, draft_len, active, cfg, state.lengths,
        lambda i: _slot_rw(state.k[i], state.v[i], writes), temperature, top_p, top_k,
        generator)
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
            generator)[1:]))
