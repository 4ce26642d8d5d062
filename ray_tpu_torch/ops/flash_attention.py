"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain versions.

Replaces the three TPU kernels of ray_tpu/ops/flash_attention.py:
  B1a ``_fwd`` + ``_fwd_kernel`` (:46-195, ``pallas_call`` at :173): causal or
      full online-softmax attention, GQA through the head index (kv head = q
      head // n_rep, never materialised), an optional segment-id mask, causal
      tiles wholly above the diagonal skipped, O in q's dtype and LSE = m +
      log(l) in f32;
  B1b ``_bwd_dq_kernel`` (:201, call :349) and B1c ``_bwd_dkv_kernel`` (:253,
      call :387, GQA sum :409-413): dQ, dK and dV with P recomputed from LSE.
``FlashAttention`` mirrors the ``custom_vjp`` at :420-440, so
``flash_attention()`` is differentiable on both devices.

The kernels are ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (CUDA C++ for
sm_90a, built by ``_build``; Hopper helpers in ``csrc/hopper.cuh``). They are
bound by the operation rate at the prefill and training shapes of the 8B
geometry, so bf16 runs every product on tensor cores with P and dS kept in
registers: the forward on wgmma fed by a TMA ring of K/V tiles, the backward
on mma.sync; f32 runs on CUDA cores. The TPU's 128-lane LSE and segment
layout is not copied: LSE and delta are [B, H, Sq] and segment ids [B, Skv].

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback between the two.
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LSE_EMPTY = -1e30  # LSE of a row with no valid key (B1a's NEG_INF)
ENCODE_ERROR_BASE = 10000  # status = this + CUresult: a tensor map was refused (hopper.cuh)

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")  # B1a, B1b, B1c

_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "flash_fwd") -> int:
    """Launches of `kernel` since the last reset (plain-version calls do not
    count)."""
    return _launches[kernel]


def reset_launch_count() -> None:
    """Zero the launch count of every kernel."""
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


def _valid(q: torch.Tensor, skv: int, causal: bool,
           segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Slots a query may attend, [B or 1, 1, Sq, Skv] bool: col <= row when
    causal (query row i at absolute position i, as in the TPU kernels) and
    equal segment ids (query row i takes the id of kv slot Skv - Sq + i)."""
    sq = q.shape[1]
    valid = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.arange(skv, device=q.device)[None, :] <= torch.arange(
            sq, device=q.device)[:, None]
    valid = valid[None, None]
    if segment_ids is not None:
        seg_q = segment_ids[:, -sq:]
        valid = valid & (seg_q[:, :, None] == segment_ids[:, None, :])[:, None]
    return valid


def flash_attention_reference(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, Skv]
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B1a: the same function in f32 math.

    Returns (O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32); rows with no
    valid key give O = 0 and LSE = LSE_EMPTY."""
    d = q.shape[3]
    n_rep = q.shape[2] // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    s = s.masked_fill(~_valid(q, k.shape[1], causal, segment_ids), float("-inf"))
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


def flash_attention_bwd_reference(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    o: torch.Tensor,  # [B, Sq, H, D], the forward's output
    lse: torch.Tensor,  # [B, H, Sq] f32, the forward's LSE
    do: torch.Tensor,  # [B, Sq, H, D]
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B1b and B1c: JAX's math in f32
    (ray_tpu/ops/flash_attention.py:201-414). P = exp(S*scale - LSE) with
    masked slots exactly 0; delta = rowsum(dO o O); dS = P o (dO V^T - delta)
    * scale; dQ = dS K, dV = P^T dO, dK = dS^T Q, the last two summed over each
    kv head's group of q heads. Returns (dq, dk, dv) in q's, k's, v's dtype."""
    b, _, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    valid = _valid(q, skv, causal, segment_ids)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    delta = (dof * o.float()).sum(dim=-1).transpose(1, 2)  # [B, H, Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(b, skv, hkv, n_rep, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(b, skv, hkv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _check_bwd(q, o, lse, do):
    """What the backward kernels take beyond _check's q, k, v."""
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"bf16 {name} must be 16-byte aligned (vector loads)")
    b, sq, h, _ = q.shape
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be contiguous f32 {(b, h, sq)} on q's device")


def _segments(segment_ids):
    return None if segment_ids is None else segment_ids.to(torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _shape_args(q, k, causal, scale):
    """The kernels' int and float arguments: B, Sq, Skv, H, Hkv, D, dtype,
    causal, scale (1/sqrt(D) by default)."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return (b, sq, k.shape[1], h, k.shape[2], d, _DTYPE_CODES[q.dtype], int(causal),
            float(scale))


def _device(q: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on anything else."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return q.device.type == "cuda"


def flash_attention_forward(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, Skv]
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1a: (O [B, Sq, H, D], LSE [B, H, Sq] f32), with no autograd.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises on anything it does not take)."""
    if not _device(q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         segment_ids=segment_ids, scale=scale)
    _check(q, k, v, segment_ids)
    from . import _build

    lib = _build.load("flash_fwd")
    seg = _segments(segment_ids)  # held while the kernel may read it
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        status = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), out.data_ptr(),
            lse.data_ptr(), *_shape_args(q, k, causal, scale),
            torch.cuda.current_stream().cuda_stream)
    if status >= ENCODE_ERROR_BASE:
        raise RuntimeError(f"flash_fwd: cuTensorMapEncodeTiled failed: CUresult "
                           f"{status - ENCODE_ERROR_BASE}")
    if status != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {status}")
    _count("flash_fwd")
    return out, lse


def launch_bwd_dq(q, k, v, o, lse, do, seg, *, causal, scale):
    """B1b on CUDA tensors checked by the caller: (dq, delta [B, H, Sq] f32).
    seg: int32 [B, Skv] or None."""
    from . import _build

    lib = _build.load("flash_bwd")
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        status = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), _ptr(seg), dq.data_ptr(), delta.data_ptr(),
            *_shape_args(q, k, causal, scale), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: cudaError {status}")
    _count("flash_bwd_dq")
    return dq, delta


def launch_bwd_dkv(q, k, v, do, lse, delta, seg, *, causal, scale):
    """B1c on CUDA tensors checked by the caller, after launch_bwd_dq on the
    same stream: (dk, dv)."""
    from . import _build

    lib = _build.load("flash_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        status = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(seg), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(q, k, causal, scale), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: cudaError {status}")
    _count("flash_bwd_dkv")
    return dk, dv


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B1b then B1c: (dq, dk, dv) in the inputs' dtypes.

    A CPU tensor takes flash_attention_bwd_reference; a CUDA tensor launches
    the dQ kernel (which also writes delta = rowsum(dO o O)) and then the
    dK/dV kernel on the same stream, or raises."""
    if not _device(q):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                             segment_ids=segment_ids, scale=scale)
    _check(q, k, v, segment_ids)
    _check_bwd(q, o, lse, do)
    seg = _segments(segment_ids)
    dq, delta = launch_bwd_dq(q, k, v, o, lse, do, seg, causal=causal, scale=scale)
    dk, dv = launch_bwd_dkv(q, k, v, do, lse, delta, seg, causal=causal, scale=scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Autograd around the kernels, as the custom_vjp at
    ray_tpu/ops/flash_attention.py:420-440: the forward saves (q, k, v, O,
    LSE), the backward recomputes P from LSE. LSE is an output without a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids, scale):
        o, lse = flash_attention_forward(q, k, v, causal=causal, segment_ids=segment_ids,
                                         scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.segment_ids, ctx.causal, ctx.scale = segment_ids, causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, causal=ctx.causal,
                                              segment_ids=ctx.segment_ids, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, Skv]
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BSHD flash attention -> (O [B, Sq, H, D], LSE [B, H, Sq] f32),
    differentiable in q, k and v through FlashAttention.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    (or raises on anything they do not take)."""
    return FlashAttention.apply(q, k, v, causal, segment_ids, scale)
