"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

Replaces the TPU kernel B1a, ``_fwd`` + ``_fwd_kernel`` in
ray_tpu/ops/flash_attention.py:46-195 (its ``pallas_call`` is at :173): causal
or full online-softmax attention, GQA through the head index (kv head = q head
// n_rep, never materialised), an optional segment-id mask, causal tiles wholly
above the diagonal skipped, O in q's dtype and LSE = m + log(l) in f32.

The kernel is ``csrc/flash_fwd.cu`` (CUDA C++ for sm_90a, built by ``_build``).
Its bound on an H100 at llama3-8b prefill shapes is the operation rate (about
1000 flops per byte moved at S=1024, against the card's ~295 in bf16), so the
bf16 path (the serving one) runs both products on tensor cores (mma.sync) with
P kept in registers; f32 runs on CUDA cores. The TPU's 128-lane LSE and
segment layout is not copied: LSE is [B, H, Sq] and segment ids [B, Skv].

Routing: a CPU tensor takes ``flash_attention_reference``; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LSE_EMPTY = -1e30  # LSE of a row with no valid key (B1a's NEG_INF)

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last reset (plain-version calls do not count)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def flash_attention_reference(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, Skv]
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same function in f32 math.

    Causal masking is col <= row (query row i at absolute position i), as in
    the TPU kernel. Returns (O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32);
    rows with no valid key give O = 0 and LSE = LSE_EMPTY."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n_rep = h // hkv
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    valid = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.arange(skv, device=q.device)[None, :] <= torch.arange(
            sq, device=q.device)[:, None]
    valid = valid[None, None]
    if segment_ids is not None:
        seg_q = segment_ids[:, -sq:]
        valid = valid & (seg_q[:, :, None] == segment_ids[:, None, :])[:, None]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)  # exp(-inf) = 0 on masked slots
    l = p.sum(dim=-1)  # [B, H, Sq]
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    l_t = l.transpose(1, 2)[..., None]  # [B, Sq, H, 1]
    out = torch.where(l_t > 0, out / l_t.clamp_min(1e-30), torch.zeros_like(out))
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, LSE_EMPTY))
    return out.to(q.dtype), lse


def _check(q, k, v, segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes BSHD tensors")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"n_heads {h} not a multiple of n_kv_heads {k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel takes "
                         "float32 or bfloat16, all three alike")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must be 16-byte aligned (vector loads)")
    if segment_ids is not None:
        if sq != k.shape[1]:
            raise ValueError("segment_ids require Sq == Skv")
        if segment_ids.shape != (b, k.shape[1]):
            raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)} != "
                             f"{(b, k.shape[1])}")
        if segment_ids.device != q.device:
            raise ValueError("segment_ids must be on q's device")


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, Skv]
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BSHD flash attention -> (O [B, Sq, H, D], LSE [B, H, Sq] f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises on anything it does not take)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         segment_ids=segment_ids, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, segment_ids)
    from . import _build

    lib = _build.load("flash_fwd")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, sq, skv, h, hkv, d, _DTYPE_CODES[q.dtype], int(causal), float(scale),
            stream)
    if status != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {status}")
    global _launches
    with _count_lock:
        _launches += 1
    return out, lse
