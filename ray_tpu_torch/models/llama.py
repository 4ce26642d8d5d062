"""Llama-family decoder-only transformer, dense path (port of ray_tpu/models/llama.py).

Parameters are a plain dict of tensors with the JAX package's tree and einsum
layout, layers stacked on a leading [L] axis: ``wq [L,d,H,hd]``, ``wk/wv
[L,d,Hkv,hd]``, ``wo [L,H,hd,d]``, ``w_gate/w_up [L,d,ff]``, ``w_down
[L,ff,d]``, ``embed [V,d]``, ``lm_head [d,V]``. Weights are read through
``ops.quant.as_weight``: cast to the activation dtype at use (a no-op when
they are stored in it), or dequantized when they are int8 ``QTensor`` leaves
(serving, W8A16). Architecture:
RMSNorm, rotate-half RoPE (HF convention), GQA, SwiGLU.

Training: ``loss_fn`` is next-token cross entropy, differentiated by
autograd; attention's gradient goes through the flash kernels' autograd
Function on CUDA. ``remat_policy`` ``full`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``); ``dots`` and ``dots_no_batch``
save the layer's matrix products and recompute the rest (selective
checkpointing).

Branches of the JAX module that the port does not run yet raise
NotImplementedError naming their ROADMAP item: MoE (A3), ring/ulysses
attention and pipeline stages (A6). The one-hot embedding branch exists only
for tensor-parallel vocab sharding (A6), which the port does not have yet, so
the gather is the whole lookup.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.quant import QTensor, as_weight

from .config import ModelConfig

Params = Dict[str, Any]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError("mixture-of-experts layers: ROADMAP A3")


# ---------------------------------------------------------------------------- init

def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (stacked layers), as init() builds it."""
    _dense_only(cfg)
    d, hd, nh, nkv, ff, n = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_ff, cfg.n_layers)
    shapes: Dict[str, Any] = {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (n, d),
            "wq": (n, d, nh, hd),
            "wk": (n, d, nkv, hd),
            "wv": (n, d, nkv, hd),
            "wo": (n, nh, hd, d),
            "mlp_norm": (n, d),
            "w_gate": (n, d, ff),
            "w_up": (n, d, ff),
            "w_down": (n, ff, d),
        },
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def init(cfg: ModelConfig, *, seed: int = 0, device=None,
         dtype: torch.dtype = torch.float32) -> Params:
    """Scaled-normal init with the JAX package's shapes and scale rules
    (ray_tpu/models/llama.py:65-110): inputs d^-0.5, wo (2*L*d)^-0.5, w_down
    (2*L*ff)^-0.5, embed 1.0, lm_head d^-0.5, norms 1. Drawn in f32 from a
    torch.Generator on the target device (so an 8B model is made on the card),
    then stored in `dtype`. The numbers are not jax.random's."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, scale):
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    s_in = d ** -0.5
    ls = shapes["layers"]
    layers = {
        "attn_norm": ones(ls["attn_norm"]),
        "wq": normal(ls["wq"], s_in),
        "wk": normal(ls["wk"], s_in),
        "wv": normal(ls["wv"], s_in),
        "wo": normal(ls["wo"], (2 * n * d) ** -0.5),
        "mlp_norm": ones(ls["mlp_norm"]),
        "w_gate": normal(ls["w_gate"], s_in),
        "w_up": normal(ls["w_up"], s_in),
        "w_down": normal(ls["w_down"], (2 * n * ff) ** -0.5),
    }
    params: Params = {
        "embed": normal(shapes["embed"], 1.0),
        "layers": layers,
        "final_norm": ones(shapes["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(shapes["lm_head"], d ** -0.5)
    return params


# ------------------------------------------------------------------------ pieces

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE (HF Llama convention), f32 math. x: [B, S, H, D],
    positions: [B, S]."""
    d = x.shape[-1]
    exps = -torch.arange(0, d // 2, dtype=torch.float32, device=x.device) / (d // 2)
    freqs = torch.pow(float(theta), exps)  # f32; a host scalar base needs no copy
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm)


def _save_dots(batch_dims: bool):
    """Selective-checkpoint policy that saves matrix products. The layers'
    einsums run as aten.bmm: a projection "bsd,dhk->bshk" with batch 1, the
    plain attention's "bqhd,bkhd->bhqk" with batch B*H. So JAX's
    checkpoint_dots is every mm, addmm and bmm (batch_dims=True), and
    dots_with_no_batch_dims_saveable is mm, addmm and a bmm of batch 1."""

    def policy(ctx, op, *args, **kwargs):
        packet = op.overloadpacket
        if packet in _DOTS and (batch_dims or packet is not torch.ops.aten.bmm
                                or args[0].shape[0] == 1):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _maybe_remat(body, cfg: ModelConfig):
    """Per-layer rematerialization (ray_tpu/models/llama.py:115-130). 'full'
    saves only the layer's input and recomputes the layer in the backward pass;
    'dots' saves every matrix product's output and recomputes the elementwise
    ops, 'dots_no_batch' saves only the products without batch dimensions;
    'none' (or remat=False) keeps every activation. The flash attention
    Function's output is not a product: it is recomputed under both dots
    policies, as the pallas_call is under JAX's."""
    policy = getattr(cfg, "remat_policy", "full")
    if not cfg.remat or policy == "none":
        return body
    if policy not in ("full", "dots", "dots_no_batch"):
        raise ValueError(
            f"unknown remat_policy {policy!r} (expected full | dots | dots_no_batch | none)")
    kw = {}
    if policy != "full":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots(policy == "dots"))

    def remat(*args):
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return remat


def _embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Token embedding gather, cast to the activation dtype (the rows only).

    Out-of-vocabulary ids follow JAX's gather (ray_tpu/models/llama.py:147-157):
    a negative id wraps once (i + V), then the id is clamped to [0, V - 1], so
    a bad prompt id reads a row instead of raising (or, on CUDA, asserting)."""
    v = table.shape[0]
    tokens = torch.where(tokens < 0, tokens + v, tokens).clamp(0, v - 1)
    return table[tokens].to(dtype)


def tree_leaves(tree: Params) -> List[Any]:
    """The leaves of a parameter-shaped dict in one fixed order (keys sorted,
    the layer dict in place of "layers"): the optimizer's order."""
    out: List[Any] = []
    for name in sorted(tree):
        val = tree[name]
        out += [val[k] for k in sorted(val)] if isinstance(val, dict) else [val]
    return out


def tree_unflatten(like: Params, leaves: List[Any]) -> Params:
    """tree_leaves' inverse: a dict shaped like `like` holding `leaves`."""
    it = iter(leaves)
    out: Params = {}
    for name in sorted(like):
        val = like[name]
        out[name] = {k: next(it) for k in sorted(val)} if isinstance(val, dict) else next(it)
    return out


def layer_params(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked layer weights (views, no copies)."""
    return {name: w.layer(i) if isinstance(w, QTensor) else w[i]
            for name, w in params["layers"].items()}


def lm_head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """[d, V] output projection (the embedding's transpose when tied)."""
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return as_weight(head, cfg.activation_dtype)


# ------------------------------------------------------------------------- forward

class KVCache(NamedTuple):
    """Stacked-per-layer KV cache: k/v [L, B, max_len, n_kv_heads, head_dim];
    `length` is the current fill (a host int, the same for every row). The
    forward writes new K/V into k/v IN PLACE and returns the same tensors."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> KVCache:
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), length=0)


def _block(
    x: torch.Tensor,
    lp: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: int = 0,
):
    """One decoder block -> (x, (k, v) cache views if caching else None).

    With a cache, this step's K/V are written into ck/cv [B, max_len, Hkv, hd]
    at cache_len in place, and the queries attend over the filled prefix."""
    _dense_only(cfg)
    dt = x.dtype
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, as_weight(lp["wq"], dt))
    k = torch.einsum("bsd,dhk->bshk", h, as_weight(lp["wk"], dt))
    v = torch.einsum("bsd,dhk->bshk", h, as_weight(lp["wv"], dt))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_kv = None
    if cache_kv is not None:
        ck, cv = cache_kv
        s = q.shape[1]
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        new_kv = (ck, cv)
        attn = attention(q, ck, cv, causal=True, q_offset=cache_len,
                         kv_valid_len=cache_len + s, impl=cfg.attention_impl)
    elif cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} (sequence parallel): ROADMAP A6")
    else:
        attn = attention(q, k, v, causal=True, segment_ids=segment_ids,
                         impl=cfg.attention_impl)
    o = torch.einsum("bshk,hkd->bsd", attn, as_weight(lp["wo"], dt))
    x = x + o

    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = torch.einsum("bsd,df->bsf", h, as_weight(lp["w_gate"], dt))
    up = torch.einsum("bsd,df->bsf", h, as_weight(lp["w_up"], dt))
    down = torch.einsum("bsf,fd->bsd", F.silu(gate) * up, as_weight(lp["w_down"], dt))
    return x + down, new_kv


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    return_aux: bool = False,
):
    """tokens [B, S] -> (logits [B, S, vocab] f32, updated cache or None).

    The cache, when given, is updated in place (see KVCache). With
    return_aux=True also returns the MoE load-balancing loss, a zero for the
    dense configs the port runs. Without a cache each layer goes through
    _maybe_remat."""
    _dense_only(cfg)
    if cfg.pipeline_stages > 1 and cache is None:
        raise NotImplementedError("pipeline_stages > 1: ROADMAP A6")
    b, s = tokens.shape
    if positions is None:
        start = cache.length if cache is not None else 0
        positions = (torch.arange(s, device=tokens.device) + start)[None, :].expand(b, s)
    x = _embed_lookup(params["embed"], tokens, cfg.activation_dtype)
    if cache is None:
        layer = _maybe_remat(
            lambda h, lp: _block(h, lp, cfg, positions, segment_ids)[0], cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cache is not None:
            x, _ = _block(x, lp, cfg, positions, segment_ids,
                          (cache.k[i], cache.v[i]), cache.length)
        else:
            x = layer(x, lp)
    new_cache = None
    if cache is not None:
        new_cache = KVCache(cache.k, cache.v, cache.length + s)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, lm_head(params, cfg)).float()
    if return_aux:
        return logits, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, new_cache


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (ray_tpu/models/llama.py:437-460). batch:
    tokens [B, S]; optional loss_mask [B, S] and segment_ids [B, S]. Inputs
    are tokens[:, :-1], targets tokens[:, 1:]; the mean runs over the masked
    targets, with a denominator of at least 1."""
    tokens = batch["tokens"]
    seg = batch.get("segment_ids")
    logits, _, aux = forward(params, tokens[:, :-1], cfg,
                             segment_ids=None if seg is None else seg[:, :-1],
                             return_aux=True)
    targets = tokens[:, 1:].long()
    # target logit minus logsumexp == log_softmax gathered at the target,
    # without a second [B, S, vocab] f32 tensor
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    ll = tgt - lse
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask[:, 1:].to(ll.dtype)
    denom = mask.sum().clamp_min(1.0)
    ce = -(ll * mask).sum() / denom
    loss = ce + aux
    return loss, {"loss": loss, "ce_loss": ce, "moe_aux_loss": aux, "tokens": denom}
