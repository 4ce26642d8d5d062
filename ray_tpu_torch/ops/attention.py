"""Attention entry point with backend dispatch (port of ray_tpu/ops/attention.py).

`attention()` is the one call sites use. Shapes are BSHD (batch, seq, heads,
head_dim) throughout; both paths take GQA (n_kv_heads <= n_heads, q head i
reads kv head i // n_rep) and causal masking.

``q_offset`` and ``kv_valid_len`` are host integers here: PyTorch runs
eagerly, so the caller knows them (JAX traces them as device scalars).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# Sq*Skv at and above which the non-flash path switches to the chunked
# online-softmax scan (the JAX package's chunked_attention_min_logits default)
CHUNKED_MIN_LOGITS = 1 << 20


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D]; head i*n_rep + r is kv head i."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    kv_valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention, the ground truth for the other paths.

    q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D]. Returns [B, Sq, H, D].
    `segment_ids`: [B, Skv]; attention only within equal segments (packing).
    `q_offset`: kv index of query row 0; default aligns the ends.
    `kv_valid_len`: kv slots >= this are masked out (padded cache tail).
    Rows with no valid kv give 0.
    """
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, skv = q.shape[1], k.shape[1]
    kj = torch.arange(skv, device=q.device)[None, :]
    neg_inf = float("-inf")
    if causal:
        if q_offset is None:
            q_offset = skv - sq
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        logits = logits.masked_fill(~(kj <= qi), neg_inf)
    if kv_valid_len is not None:
        logits = logits.masked_fill(~(kj < kv_valid_len), neg_inf)
    if segment_ids is not None:
        seg_q = segment_ids[:, -sq:]
        mask = seg_q[:, :, None] == segment_ids[:, None, :]
        logits = logits.masked_fill(~mask[:, None], neg_inf)
    # rows with no valid kv softmax to NaN; zero them instead
    probs = torch.nan_to_num(torch.softmax(logits, dim=-1))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    kv_valid_len: Optional[int] = None,
    block_kv: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks: peak memory O(B*H*Sq*block_kv)
    instead of O(B*H*Sq*Skv). Same masking surface as attention_reference."""
    n_rep = q.shape[2] // k.shape[2]
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    seg_q = None if segment_ids is None else segment_ids[:, -sq:]
    if q_offset is None:
        q_offset = skv - sq
    qi = torch.arange(sq, device=dev)[:, None] + q_offset  # [Sq, 1] kv positions
    valid_len = kv_valid_len if kv_valid_len is not None else skv
    neg = -1e30  # finite: keeps fully-masked rows NaN-free
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    for start in range(0, skv, block_kv):
        kc = _repeat_kv(k[:, start:start + block_kv], n_rep)
        vc = _repeat_kv(v[:, start:start + block_kv], n_rep)
        kj = start + torch.arange(kc.shape[1], device=dev)[None, :]  # [1, blk]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) * scale
        if causal:
            logits = logits.masked_fill(~(kj <= qi)[None, None], neg)
        logits = logits.masked_fill(~(kj < valid_len)[None, None], neg)
        if seg_q is not None:
            seg_c = segment_ids[:, start:start + block_kv]
            mask = seg_q[:, :, None] == seg_c[:, None, :]  # [B, Sq, blk]
            logits = logits.masked_fill(~mask[:, None], neg)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[..., None])
        # kill masked slots exactly: on a fully masked row new_m == neg and
        # exp(logits - new_m) == 1, which would silently average v
        p = torch.where(logits > neg * 0.5, p, torch.zeros_like(p))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype), vc)
        acc = acc * corr.transpose(1, 2)[..., None] + pv.float()
        m = new_m
    l_t = l.transpose(1, 2)[..., None]  # [B, Sq, H, 1]
    out = torch.where(l_t > 0, acc / l_t.clamp_min(1e-30), torch.zeros_like(acc))
    return out.to(q.dtype)


def choose_impl(on_cuda: bool, sq: int, skv: int, *, causal: bool,
                q_offset: Optional[int], kv_valid_len: Optional[int]) -> str:
    """The auto rule of attention(): flash | chunked | reference."""
    trivial = sq == skv and q_offset in (None, 0) and kv_valid_len in (None, skv)
    no_offsets = q_offset is None and kv_valid_len is None
    if on_cuda and (trivial or (no_offsets and not causal)):
        return "flash"
    if sq * skv >= CHUNKED_MIN_LOGITS:
        return "chunked"
    return "reference"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
    kv_valid_len: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention. impl: auto|flash|chunked|reference.

    auto: on CUDA, the flash kernel takes every call whose offsets are trivial
    (Sq == Skv, q_offset in (None, 0), kv_valid_len in (None, Skv)) or that is
    non-causal without offsets, like the Pallas rule of the JAX package. That
    is exactly every prefill: the cache starts empty, so attention over it is
    causal self-attention. Such a call on CUDA never takes a plain path; the
    kernel raises on a shape it does not take. Everything else goes to the
    chunked scan at and above CHUNKED_MIN_LOGITS, else to the reference.
    """
    if impl == "auto":
        impl = choose_impl(q.is_cuda, q.shape[1], k.shape[1], causal=causal,
                           q_offset=q_offset, kv_valid_len=kv_valid_len)
    if impl == "flash":  # differentiable through FlashAttention (backward kernels)
        from .flash_attention import flash_attention

        out, _ = flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                 scale=scale)
        return out
    if impl == "chunked":
        return attention_chunked(q, k, v, causal=causal, segment_ids=segment_ids,
                                 scale=scale, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len)
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, segment_ids=segment_ids,
                                   scale=scale, q_offset=q_offset,
                                   kv_valid_len=kv_valid_len)
    raise ValueError(f"unknown attention impl {impl!r} (auto|flash|chunked|reference)")
