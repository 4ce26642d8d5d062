"""Paged KV cache: block-granular memory for continuous batching
(port of ray_tpu/llm/paged.py, one device).

The slot cache reserves max_model_len tokens per slot up front; paging shares
one pool of blocks across slots and allocates per block of kv_block_size
tokens, so many short sequences (or a few long ones) fit the same memory. The
pool is [L, num_blocks + 1, block, kv_heads, head_dim]; each slot owns a
fixed-width block table [max_blocks] of pool indices, reads gather through it
and writes scatter through it. The last block is scratch: never allocated,
it takes the writes of inactive slots, whose tables may point at blocks that
other requests own by now.

Host side, _BlockManager hands out pool indices and keeps the prefix cache;
when the pool runs dry the engine preempts the youngest request and prefills
it again later (vLLM's recompute preemption).

Unlike the JAX functions (pure, with donated buffers), these update the
PagedState's tensors IN PLACE and return the same object. The block gather
and the attention of a paged decode step are plain PyTorch, as in the JAX
package, which has no Pallas kernel for them. Speculative verify shares the
slot layout's window layer body through the same adapter. The data-parallel
and pipelined variants are later slices (ROADMAP A6).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.config import ModelConfig

from .model_runner import (_burst, _decode_layers, _window_positions, propose_ngram_device,
                           spec_driver, spec_multi_impl)


class PagedState(NamedTuple):
    """Device-resident paged serving state.

    k/v: [L, num_blocks + 1, block_size, kv_heads, head_dim], the shared pool
        (the last block is scratch).
    block_tables: [slots, max_blocks] int64 pool indices (entries past a
        slot's length are masked at read time).
    lengths: [slots] int64 tokens cached per slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor


def init_paged_state(cfg: ModelConfig, slots: int, max_len: int, num_blocks: int,
                     block_size: int, device=None,
                     dtype: Optional[torch.dtype] = None) -> PagedState:
    """A pool of num_blocks blocks plus one scratch block (its last index)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedState(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        block_tables=torch.zeros((slots, max_len // block_size), dtype=torch.int64,
                                 device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int64, device=dev),
    )


class _BlockManager:
    """Host-side free list + per-slot allocation bookkeeping, with a
    prefix cache (reference: vLLM automatic prefix caching): full prompt
    blocks are content-addressed by a hash CHAIN (block key = H(parent key,
    block tokens)), shared across slots via refcounts, and kept around at
    refcount 0 until the pool needs the space (LRU eviction).

    A copy of ray_tpu/llm/paged.py:121-271 (the port imports nothing of the
    JAX package); tests hold the two to the same ids step by step."""

    def __init__(self, num_blocks: int, block_size: int, max_blocks_per_slot: int,
                 slots: int, enable_prefix_caching: bool = True):
        self.block_size = block_size
        self.max_blocks = max_blocks_per_slot
        self.total_blocks = num_blocks
        self.free: List[int] = list(range(num_blocks))
        self.owned: List[List[int]] = [[] for _ in range(slots)]  # includes shared
        self.shared: List[List[int]] = [[] for _ in range(slots)]  # shared subset
        self.enable_prefix_caching = enable_prefix_caching
        self.cached: Dict[bytes, int] = {}  # chain key -> block id
        self.block_key: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}  # cached block id -> live references
        self._lru: Dict[int, int] = {}  # ref-0 cached block -> last-use tick
        self._tick = 0
        self.hit_tokens = 0  # metrics: prompt tokens served from the cache

    @staticmethod
    def chain_keys(prompt: List[int], block_size: int) -> List[bytes]:
        """Hash-chain keys for each FULL block of the prompt."""
        keys = []
        parent = b""
        for start in range(0, (len(prompt) // block_size) * block_size, block_size):
            h = hashlib.sha256(parent)
            h.update(np.asarray(prompt[start:start + block_size], np.int64).tobytes())
            parent = h.digest()
            keys.append(parent)
        return keys

    @property
    def num_free(self) -> int:
        # ref-0 cached blocks are reclaimable on demand
        return len(self.free) + len(self._lru)

    def blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def can_allocate(self, n: int) -> bool:
        return self.num_free >= n

    def _take_free(self) -> int:
        if self.free:
            return self.free.pop()
        # evict the least-recently-used unreferenced cached block
        victim = min(self._lru, key=self._lru.get)
        self._lru.pop(victim)
        key = self.block_key.pop(victim)
        self.cached.pop(key, None)
        self.refs.pop(victim, None)
        return victim

    def allocate(self, slot: int, n: int) -> List[int]:
        if self.num_free < n:
            raise RuntimeError("pool exhausted (caller must check/preempt)")
        got = [self._take_free() for _ in range(n)]
        self.owned[slot].extend(got)
        return got

    def match_prefix(self, slot: int, prompt: List[int]) -> List[int]:
        """Attach the longest cached block chain for this prompt to the slot
        (bumping refcounts); returns the matched block ids in order. Always
        leaves >= 1 prompt token uncached so prefill still produces the
        last-token logits."""
        if not self.enable_prefix_caching:
            return []
        usable = len(prompt) - 1  # the final token must be computed
        matched: List[int] = []
        for key in self.chain_keys(prompt[:usable] if usable > 0 else [],
                                   self.block_size):
            bid = self.cached.get(key)
            if bid is None:
                break
            matched.append(bid)
        if matched:
            # round DOWN to a power of two of blocks, as the JAX package does
            # to bound its compiled variants; kept so both cache the same
            matched = matched[: 1 << (len(matched).bit_length() - 1)]
        for bid in matched:
            if self.refs.get(bid, 0) == 0:
                self._lru.pop(bid, None)
            self.refs[bid] = self.refs.get(bid, 0) + 1
        self.owned[slot].extend(matched)
        self.shared[slot].extend(matched)
        return matched

    def register_blocks(self, slot: int, prompt: List[int],
                        block_ids: List[int], skip_blocks: int) -> None:
        """Publish a slot's freshly filled FULL prompt blocks into the cache
        (the slot keeps them as shared from now on)."""
        if not self.enable_prefix_caching:
            return
        keys = self.chain_keys(prompt, self.block_size)
        for i, key in enumerate(keys):
            if i < skip_blocks:
                continue  # already cached (matched prefix)
            if i >= len(block_ids):
                break
            bid = block_ids[i]
            if key in self.cached:
                continue  # raced by an identical prompt; keep ours private
            self.cached[key] = bid
            self.block_key[bid] = key
            self.refs[bid] = self.refs.get(bid, 0) + 1
            if bid in self.owned[slot] and bid not in self.shared[slot]:
                self.shared[slot].append(bid)

    def release(self, slot: int) -> None:
        shared = set(self.shared[slot])
        self._tick += 1
        for bid in self.owned[slot]:
            if bid in shared:
                self.refs[bid] = self.refs.get(bid, 1) - 1
                if self.refs[bid] <= 0:
                    self.refs[bid] = 0
                    self._lru[bid] = self._tick  # reclaimable, still cached
            else:
                self.free.append(bid)
        self.owned[slot] = []
        self.shared[slot] = []

    def slot_capacity(self, slot: int) -> int:
        return len(self.owned[slot]) * self.block_size

    def max_fit(self, slot: int) -> int:
        """Largest block count a request in this slot could ever hold."""
        return min(self.total_blocks, self.max_blocks)


def make_block_manager(num_blocks: int, block_size: int, max_blocks_per_slot: int,
                       slots: int, dp: int = 1,
                       enable_prefix_caching: bool = True) -> _BlockManager:
    if dp > 1:
        raise NotImplementedError("paged KV with data_parallel_size > 1: ROADMAP A6")
    return _BlockManager(num_blocks, block_size, max_blocks_per_slot, slots,
                         enable_prefix_caching)


def _ids(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.int64, device=device)


# ----------------------------------------------------------------- prefill install

@torch.no_grad()
def install_prefill(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                    block_ids: Sequence[int], true_len: int, slot: int,
                    n_blocks: int) -> PagedState:
    """Scatter a prompt's KV [L, 1, n_blocks*bs, KV, HD] into its allocated
    blocks and fill the slot's block table (in place)."""
    n_layers, bs = state.k.shape[0], state.k.shape[2]
    ids = _ids(block_ids, state.k.device)
    state.k[:, ids] = k[:, 0].reshape(n_layers, n_blocks, bs, *k.shape[3:]).to(state.k.dtype)
    state.v[:, ids] = v[:, 0].reshape(n_layers, n_blocks, bs, *v.shape[3:]).to(state.v.dtype)
    state.block_tables[slot] = 0
    state.block_tables[slot, :n_blocks] = ids
    state.lengths[slot] = true_len
    return state


@torch.no_grad()
def append_block(state: PagedState, slot: int, index: int, block_id: int) -> PagedState:
    """Record a newly allocated decode block in a slot's table."""
    state.block_tables[slot, index] = block_id
    return state


# ----------------------------------------------------------------- prefix cache

@torch.no_grad()
def gather_blocks(state: PagedState, block_ids: Sequence[int], n_blocks: int):
    """Cached prefix blocks -> contiguous KV context [L, 1, n*bs, KV, HD]: a
    COPY (the pool is written in place later, the context is read first)."""
    ids = _ids(block_ids, state.k.device)
    kb, vb = state.k[:, ids], state.v[:, ids]  # [L, n, bs, KV, HD], gathered copies
    shape = (kb.shape[0], 1, n_blocks * kb.shape[2]) + tuple(kb.shape[3:])
    return kb.reshape(shape), vb.reshape(shape)


@torch.no_grad()
def prefill_suffix_from_state(params, state: PagedState, block_ids: Sequence[int],
                              tokens: torch.Tensor, true_suffix_len: int,
                              cfg: ModelConfig, n_blocks: int):
    """gather_blocks + the suffix prefill, as one call in the JAX package."""
    ctx_k, ctx_v = gather_blocks(state, block_ids, n_blocks)
    return _prefill_suffix_impl(params, ctx_k, ctx_v, tokens, true_suffix_len, cfg)


def _prefill_suffix_impl(params, ctx_k, ctx_v, tokens, true_suffix_len: int,
                         cfg: ModelConfig):
    """Prefill ONLY the uncached suffix, attending over the cached-prefix KV
    context (reference: vLLM prefix caching skips recomputation of shared
    prompt prefixes). ctx_k/ctx_v: [L, 1, C, KV, HD]; tokens [1, S_pad].
    Returns (k_suffix [L, 1, S_pad, KV, HD], v_suffix, last_logits). The
    queries sit at q_offset = C > 0, so attention takes the chunked or the
    reference path, never the flash kernel (as under the JAX Pallas rule)."""
    cached_len = ctx_k.shape[2]
    s_pad = tokens.shape[1]
    cache = llama.init_kv_cache(cfg, batch=1, max_len=cached_len + s_pad,
                                device=tokens.device)
    cache.k[:, :, :cached_len] = ctx_k
    cache.v[:, :, :cached_len] = ctx_v
    logits, cache = llama.forward(params, tokens, cfg,
                                  cache=cache._replace(length=cached_len))
    last = logits[0, true_suffix_len - 1].float()
    return cache.k[:, :, cached_len:], cache.v[:, :, cached_len:], last


@torch.no_grad()
def install_with_prefix(state: PagedState, k_suf: torch.Tensor, v_suf: torch.Tensor,
                        new_ids: Sequence[int], table_row: Sequence[int], true_len: int,
                        slot: int, n_new: int) -> PagedState:
    """Install suffix KV into fresh blocks; cached-prefix blocks are already in
    the pool and only need table entries (table_row: the whole row)."""
    n_layers, bs = state.k.shape[0], state.k.shape[2]
    ids = _ids(new_ids, state.k.device)
    state.k[:, ids] = k_suf[:, 0].reshape(n_layers, n_new, bs,
                                          *k_suf.shape[3:]).to(state.k.dtype)
    state.v[:, ids] = v_suf[:, 0].reshape(n_layers, n_new, bs,
                                          *v_suf.shape[3:]).to(state.v.dtype)
    state.block_tables[slot] = _ids(table_row, state.k.device)
    state.lengths[slot] = true_len
    return state


# ------------------------------------------------------------------------- decode

def _write_positions(state: PagedState, active: torch.Tensor, wlen: int = 1):
    """(pool block, offset) [slots, wlen] where the K/V of positions
    lengths[s] + w of each slot go (a decode step is wlen = 1, a verify
    window k + 1).

    Active slots own distinct blocks, so their writes never collide; the
    engine grows their tables by the window first. An INACTIVE slot's table
    may point at blocks that were released and are owned by another request
    now, so its writes go to the scratch block (the pool's last), as do
    positions past the table's width; the table index is clamped to the
    width for the lookup."""
    s, nb_slot = state.block_tables.shape
    bs = state.k.shape[2]
    pos = _window_positions(state.lengths, wlen)
    rows = torch.arange(s, device=pos.device)[:, None]
    blk = pos // bs
    safe_idx = torch.clamp(blk, max=nb_slot - 1)
    scratch = torch.full_like(pos, state.k.shape[1] - 1)
    owned = active[:, None] & (blk < nb_slot)
    return torch.where(owned, state.block_tables[rows, safe_idx], scratch), pos % bs


def _paged_rw(pk, pv, block_tables, write_block, write_off):
    """The paged layout's cache adapter for one layer's pool pk/pv
    [NB+1, bs, KV, HD]: this window's K/V [S, W, KV, HD] scattered to
    (write_block, write_off) [S, W], then each slot's blocks gathered into
    [S, max_len, KV, HD]. The scatter does not accumulate: duplicate scratch
    indices are harmless, since no table holds the scratch block."""
    s, nb_slot = block_tables.shape
    bs, kvh, hd = pk.shape[1], pk.shape[2], pk.shape[3]

    def cache_rw(k_new, v_new):
        pk[write_block, write_off] = k_new.to(pk.dtype)
        pv[write_block, write_off] = v_new.to(pv.dtype)
        ck = pk[block_tables].reshape(s, nb_slot * bs, kvh, hd)
        cv = pv[block_tables].reshape(s, nb_slot * bs, kvh, hd)
        return ck, cv

    return cache_rw


@torch.no_grad()
def decode_step_paged(
    params,
    state: PagedState,
    tokens: torch.Tensor,  # [slots] int
    active: torch.Tensor,  # [slots] bool
    cfg: ModelConfig,
) -> Tuple[PagedState, torch.Tensor]:
    """One decode step for every slot against the paged pool -> (state,
    logits [slots, vocab] f32); pool and lengths updated in place."""
    write_block, write_off = _write_positions(state, active, 1)
    logits = _decode_layers(params, tokens, active, cfg, state.lengths, lambda i: _paged_rw(
        state.k[i], state.v[i], state.block_tables, write_block, write_off))
    return state, logits


@torch.no_grad()
def decode_multi_paged(
    params,
    state: PagedState,
    tokens: torch.Tensor,  # [slots] int
    active: torch.Tensor,  # [slots] bool — fixed for the whole burst
    cfg: ModelConfig,
    n_steps: int,
    temperature: torch.Tensor,  # [slots] f32
    top_p: torch.Tensor,  # [slots] f32
    top_k: torch.Tensor,  # [slots] int
    steps_left: torch.Tensor,  # [slots] int — per-slot step budget within the burst
    generator: Optional[torch.Generator] = None,
) -> Tuple[PagedState, torch.Tensor]:
    """n_steps fused decode+sample steps against the paged pool (one host
    sync per burst) -> (state, tokens [n_steps, slots]). Callers pre-grow
    every active slot's block table by min(n_steps, steps_left[s]) tokens:
    the tables are frozen across the burst. A slot past its own budget goes
    inactive for the remaining steps (its writes land in the scratch block)."""
    return _burst(lambda st, toks, act: decode_step_paged(params, st, toks, act, cfg),
                  state, tokens, active, n_steps, temperature, top_p, top_k, steps_left,
                  generator)


@torch.no_grad()
def spec_verify_step_paged(
    params,
    state: PagedState,
    window: torch.Tensor,  # [S,W] int — [last_token, draft_1..draft_k]
    draft_len: torch.Tensor,  # [S] int
    active: torch.Tensor,  # [S] bool
    cfg: ModelConfig,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
):
    """Speculative verify against the paged pool (see
    model_runner.spec_verify_step for the contract). The engine grows every
    active slot's table by the window first, so each window position below
    max_len maps to a block the slot owns."""
    write_block, write_off = _write_positions(state, active, window.shape[1])
    toks, n_acc, logits = spec_driver(
        params, window, draft_len, active, cfg, state.lengths,
        lambda i: _paged_rw(state.k[i], state.v[i], state.block_tables, write_block,
                            write_off),
        temperature, top_p, top_k, generator)
    return (state, toks, n_acc, logits) if return_logits else (state, toks, n_acc)


@torch.no_grad()
def spec_multi_paged(
    params,
    state: PagedState,
    hist: torch.Tensor,  # [S, width] int — prompt + emitted tokens per slot
    hlen: torch.Tensor,  # [S] int
    active: torch.Tensor,  # [S] bool — fixed for the whole burst
    cfg: ModelConfig,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    m: int,
    k: int,
    nmax: int,
    propose_fn=None,
    generator: Optional[torch.Generator] = None,
):
    """m fused speculative windows against the paged pool (see
    model_runner.spec_multi). Callers grow every active slot's table by
    m*(k+1) tokens first: the tables are frozen across the burst, and window
    positions past a slot's table land in the scratch block (never read
    back, since lengths advance only over accepted tokens, which do have
    table entries)."""
    return (state, *spec_multi_impl(
        hist, hlen, active, temperature, m, k, nmax, propose_fn or propose_ngram_device,
        lambda window, draft_len: spec_verify_step_paged(
            params, state, window, draft_len, active, cfg, temperature, top_p, top_k,
            generator)[1:]))


class PagedOps:
    """Engine-facing calls of the paged device ops for one pool (the JAX
    class also routes dp > 1 and pp > 1 through sharded variants: ROADMAP A6)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def install_prefill(self, state, k, v, block_ids, true_len, slot, n_blocks):
        return install_prefill(state, k, v, block_ids, true_len, slot, n_blocks)

    def install_with_prefix(self, state, k_suf, v_suf, new_ids, table_row, true_len,
                            slot, n_new):
        return install_with_prefix(state, k_suf, v_suf, new_ids, table_row, true_len,
                                   slot, n_new)

    def append_block(self, state, slot, index, block_id):
        return append_block(state, slot, index, block_id)

    def prefill_suffix_from_state(self, params, state, block_ids, tokens,
                                  true_suffix_len, n_blocks):
        return prefill_suffix_from_state(params, state, block_ids, tokens,
                                         true_suffix_len, self.cfg, n_blocks)

    def decode_step(self, params, state, tokens, active):
        return decode_step_paged(params, state, tokens, active, self.cfg)

    def decode_multi(self, params, state, tokens, active, n_steps, temperature, top_p,
                     top_k, steps_left, generator=None):
        return decode_multi_paged(params, state, tokens, active, self.cfg, n_steps,
                                  temperature, top_p, top_k, steps_left, generator)

    def spec_verify(self, params, state, window, draft_len, active, temperature, top_p,
                    top_k, generator=None):
        return spec_verify_step_paged(params, state, window, draft_len, active, self.cfg,
                                      temperature, top_p, top_k, generator)

    def spec_multi(self, params, state, hist, hlen, active, temperature, top_p, top_k, m,
                   k, nmax, generator=None):
        return spec_multi_paged(params, state, hist, hlen, active, self.cfg, temperature,
                                top_p, top_k, m, k, nmax, generator=generator)


# ------------------------------------------------------------------ chunked prefill

@torch.no_grad()
def chunked_prefill(params, prompt_ids: List[int], cfg: ModelConfig, chunk: int,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill a long prompt chunk at a time (reference: vLLM chunked prefill).

    Peak activation memory is one chunk's, not the whole prompt's; the KV
    grows to the chunk-padded prompt length and is installed afterwards.
    Returns (k [L,1,S_pad,KV,HD], v, last_logits [vocab] f32). Each chunk is
    one forward over the growing cache (the JAX package's _prefill_chunk); it
    attends with kv_valid_len set (and the later ones at q_offset > 0), so it
    takes the chunked or the reference attention path."""
    dev = resolve_device(device)
    n = len(prompt_ids)
    s_pad = -(-n // chunk) * chunk
    cache = llama.init_kv_cache(cfg, batch=1, max_len=s_pad, device=dev)
    last = None
    for start in range(0, s_pad, chunk):
        piece = prompt_ids[start:start + chunk]
        tokens = torch.zeros((1, chunk), dtype=torch.int64)
        tokens[0, :len(piece)] = torch.as_tensor(piece, dtype=torch.int64)
        logits, cache = llama.forward(params, tokens.to(dev), cfg, cache=cache)
        if start < n <= start + chunk:
            last = logits[0, (n - 1) - start].float()
    return cache.k, cache.v, last
