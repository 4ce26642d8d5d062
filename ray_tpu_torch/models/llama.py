"""Llama-family decoder-only transformer (port of ray_tpu/models/llama.py).

Parameters are a plain dict of tensors with the JAX package's tree and einsum
layout, layers stacked on a leading [L] axis: ``wq [L,d,H,hd]``, ``wk/wv
[L,d,Hkv,hd]``, ``wo [L,H,hd,d]``, ``w_gate/w_up [L,d,ff]``, ``w_down
[L,ff,d]``, ``embed [V,d]``, ``lm_head [d,V]``. A mixture-of-experts config
(n_experts > 0) holds ``router [L,d,E]``, ``w_gate/w_up [L,E,d,ff]`` and
``w_down [L,E,ff,d]`` in place of the dense MLP, computed by
``models/moe.py``. Weights are read through ``ops.quant.as_weight``: cast to
the activation dtype at use (a no-op when they are stored in it), or
dequantized when they are int8 ``QTensor`` leaves (serving, W8A16).
Architecture: RMSNorm, rotate-half RoPE (HF convention), GQA, SwiGLU.

Training: ``loss_fn`` is next-token cross entropy plus the MoE load-balancing
loss, differentiated by autograd; attention's gradient goes through the
flash kernels' autograd Function on CUDA. ``remat_policy`` ``full``
recomputes each layer in the backward pass (``torch.utils.checkpoint``);
``dots`` and ``dots_no_batch`` save the layer's matrix products and
recompute the rest (selective checkpointing).

Tensor parallelism: with a ``mesh`` whose "tp" axis holds n > 1 ranks,
each rank holds its shard of the weights (``param_axes`` and
``parallel.shard_pytree``: heads, kv heads, the MLP's hidden units and the
vocabulary cut in n) and runs the same forward on it. Head counts come from
the local weights' shapes; the attention output projection and the MLP's
down projection end in an all-reduce over "tp", and the column-parallel
products (wq/wk/wv, w_gate/w_up, the head) begin with ``copy_to`` (the
identity, whose backward sums the gradient over "tp": Megatron's f/g pair);
the embedding is a vocab-parallel lookup (each rank's rows, the others
masked, then an all-reduce), and the logits are all-gathered over the
vocabulary, so every rank holds the same logits, unless the caller keeps
each rank's columns (``local_logits``: the loss's vocab-parallel cross
entropy). Where JAX's sharded lookup is a one-hot product (out-of-range ids
embed to zeros), the port keeps the gather's wrap-then-clamp on the global
vocabulary.

Training on a mesh (``loss_fn(mesh=)``, TRAIN_RULES by default, as
ray_tpu/train/step.py shards by them): every leaf is also cut over "fsdp"
along its "embed" dim, and the forward gathers a layer's leaves where the
layer uses them (``parallel.gather_leaf``: inside the remat body, so a
remat policy gathers again in the backward instead of keeping every layer
whole; the gather's backward is a reduce-scatter); each rank takes its
slice of the global batch by the rules' "batch" axes (dp, fsdp), and the
loss is the global token mean. A mixture-of-experts model under tp > 1 or on
a training mesh (the experts' "mlp" axis and "ep"), sequence parallelism
(sp, ring/ulysses attention) and training over pipeline stages (pp) raise
NotImplementedError naming ROADMAP A6.

Pipeline stages in serving (a mesh whose "pp" axis holds P > 1 ranks, and
rules that cut the stacked "layer" axis over "pp":
llm/model_runner.infer_rules_for_mesh): a stage holds its n_layers / P
layers (``init``, ``local_layers``) and a KV cache of those layers
(``init_kv_cache``), and ``forward`` with a cache runs them as one stage of
the chain: stage 0 embeds, every later stage receives the previous one's
hidden states, and the last stage's rows reach every stage before the final
norm and the head (parallel/pipeline.py), so every rank holds the logits.
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
from ray_tpu_torch.ops.quant import (LLAMA_QUANT_KEYS, QTensor, as_weight, empty_qtensor,
                                     layer_contract_axis, quantize, quantize_layer,
                                     quantize_layer_)
from ray_tpu_torch.parallel import pipeline
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.sharding import (INFER_RULES, TRAIN_RULES, AxisRules, all_gather,
                                             all_reduce, copy_to, gather_leaf, local_range,
                                             local_shape, shard_leaf, shard_view)

from . import moe
from .config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------- init

def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (stacked layers), as init() builds it."""
    d, hd, nh, nkv, ff, n = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_ff, cfg.n_layers)
    layer = {
        "attn_norm": (d,),
        "wq": (d, nh, hd),
        "wk": (d, nkv, hd),
        "wv": (d, nkv, hd),
        "wo": (nh, hd, d),
        "mlp_norm": (d,),
    }
    if cfg.n_experts > 0:
        layer.update(moe.expert_shapes(cfg))
    else:
        layer.update({"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)})
    shapes: Dict[str, Any] = {
        "embed": (cfg.vocab_size, d),
        "layers": {name: (n,) + shape for name, shape in layer.items()},
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical-axis tree mirroring init()'s output, a leading "layer" axis on
    the stacked layer leaves (ray_tpu/models/llama.py:30-62, scanned)."""
    layers = {
        "attn_norm": ("embed",),
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "mlp_norm": ("embed",),
    }
    if cfg.n_experts > 0:
        layers.update(moe.EXPERT_AXES)
    else:
        layers.update({"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                       "w_down": ("mlp", "embed")})
    axes: Dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "layers": {name: ("layer",) + ax for name, ax in layers.items()},
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def check_tensor_parallel(cfg: ModelConfig, mesh) -> None:
    """Refuse what tensor parallelism does not serve: a MoE model under
    tp > 1 (ROADMAP A6)."""
    if cfg.n_experts > 0 and axis_size(mesh, "tp") > 1:
        raise NotImplementedError(
            "a mixture-of-experts model under tensor parallelism (the experts' mlp "
            "axis and ep): ROADMAP A6")


def check_training_mesh(cfg: ModelConfig, mesh) -> None:
    """Refuse what training on a mesh does not run yet: a MoE model (its
    experts over "ep"), and sp or pp axes of more than one rank (ROADMAP
    A6)."""
    if mesh is None:
        return
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "a mixture-of-experts model on a training mesh (expert parallelism, ep): "
            "ROADMAP A6")
    for axis, what in (("sp", "sequence parallelism (ring/ulysses attention)"),
                       ("pp", "pipeline parallelism")):
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(f"{what}: a training mesh with {axis} = "
                                      f"{axis_size(mesh, axis)}: ROADMAP A6")


def _init_scales(cfg: ModelConfig) -> Dict[str, float]:
    """Per-leaf init scales of ray_tpu/models/llama.py:65-110 and
    ray_tpu/models/moe.py:130-141 (0 = ones)."""
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    scales = {"attn_norm": 0.0, "mlp_norm": 0.0, "final_norm": 0.0, "embed": 1.0,
              "lm_head": d ** -0.5, "wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
              "wo": (2 * n * d) ** -0.5}
    if cfg.n_experts > 0:
        scales.update(moe.expert_scales(cfg))
    else:
        scales.update({"w_gate": d ** -0.5, "w_up": d ** -0.5,
                       "w_down": (2 * n * ff) ** -0.5})
    return scales


@torch.no_grad()
def init(cfg: ModelConfig, *, seed: int = 0, device=None,
         dtype: torch.dtype = torch.float32, quantize_int8: bool = False,
         mesh=None, rules: AxisRules = INFER_RULES) -> Params:
    """Scaled-normal init with the JAX package's shapes and scale rules
    (ray_tpu/models/llama.py:65-110, moe.py:130-141): inputs d^-0.5, wo
    (2*L*d)^-0.5, w_down (2*L*ff)^-0.5, embed 1.0, lm_head d^-0.5, norms 1.
    Drawn in f32 from a torch.Generator on the target device, one layer of
    one leaf at a time (layer-major: every leaf of layer 0, then layer 1,
    ...; then embed and lm_head), each stored at once into a preallocated
    tensor of `dtype`: the peak holds the model plus one layer's slice of
    one leaf in f32, so an 8B model, or mixtral in int8, is made on the card.
    The numbers are not jax.random's.

    quantize_int8=True quantizes each layer's matmul slice and the untied
    head as they are drawn: bit for bit quantize_llama_params(init(cfg,
    seed=seed, dtype=dtype)), without ever holding the float model.

    With a `mesh`, each rank draws every piece whole (the same numbers on
    every rank), quantizes it whole, and keeps its shard by `rules`
    (INFER_RULES for serving, TRAIN_RULES for training; a pipeline stage's
    rules cut "layer" over "pp", and the stage keeps its layers only): bit
    for bit shard_pytree of the unsharded init, holding the shards plus one
    piece."""
    dev = resolve_device(device)
    check_tensor_parallel(cfg, mesh)
    shapes, scales, axes = param_shapes(cfg), _init_scales(cfg), param_axes(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, scale):
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    def shard(x, leaf_axes):  # a copy: the whole draw is freed
        return shard_leaf(x, leaf_axes, mesh, rules)

    def piece(x, leaf_axes):  # a view: the store into the leaf copies it
        return shard_view(x, leaf_axes[1:], mesh, rules)

    ls, la = shapes["layers"], axes["layers"]
    held = local_range(cfg.n_layers, "layer", mesh, rules)  # this stage's layers
    layers: Params = {}
    for name, shape in ls.items():
        shape = local_shape(shape, la[name], mesh, rules)
        if quantize_int8 and name in LLAMA_QUANT_KEYS:
            layers[name] = empty_qtensor(shape, layer_contract_axis(name, ls), dev)
        elif scales[name] == 0.0:
            layers[name] = ones(shape)
        else:
            layers[name] = torch.empty(shape, device=dev, dtype=dtype)
    for i in range(cfg.n_layers):
        for name, shape in ls.items():
            if scales[name] == 0.0:
                continue
            # every stage draws every layer, so the stream is one rank's
            w = draw(shape[1:], scales[name])
            if i not in held:
                continue
            j = i - held.start
            dst, axis = layers[name], layer_contract_axis(name, ls)
            if not isinstance(dst, QTensor):
                dst[j] = piece(w, la[name])
            elif tuple(dst.q.shape[1:]) == tuple(w.shape):
                quantize_layer_(dst, j, w, axis)  # unsharded: in place
            else:  # scales from the whole piece, then the shard
                dst.q[j], dst.s[j] = piece(quantize_layer(w, axis), la[name])
    params: Params = {
        "embed": shard(draw(shapes["embed"], 1.0), axes["embed"]),
        "layers": layers,
        "final_norm": ones(local_shape(shapes["final_norm"], axes["final_norm"], mesh, rules)),
    }
    if not cfg.tie_embeddings:
        head = draw(shapes["lm_head"], scales["lm_head"])
        params["lm_head"] = shard(quantize(head, 0) if quantize_int8 else head,
                                  axes["lm_head"])
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
                  dtype: torch.dtype, mesh=None) -> torch.Tensor:
    """Token embedding gather, cast to the activation dtype (the rows only).

    Out-of-vocabulary ids follow JAX's gather (ray_tpu/models/llama.py:147-157):
    a negative id wraps once (i + V), then the id is clamped to [0, V - 1], so
    a bad prompt id reads a row instead of raising (or, on CUDA, asserting).

    Under tp > 1 the table is this rank's rows of the vocabulary: ids are
    wrapped and clamped against the GLOBAL V first, each rank reads the rows
    it holds, zeros the rest, and an all-reduce joins them (exact: one row
    plus zeros)."""
    n = axis_size(mesh, "tp")
    v_local = table.shape[0]
    v = v_local * n
    tokens = torch.where(tokens < 0, tokens + v, tokens).clamp(0, v - 1)
    if n == 1:
        return table[tokens].to(dtype)
    local = tokens - axis_index(mesh, "tp") * v_local
    mine = (local >= 0) & (local < v_local)
    rows = table[local.clamp(0, v_local - 1)].to(dtype)
    return all_reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)), mesh)


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


def local_layers(params: Params) -> int:
    """The stacked layers a parameter dict holds: n_layers, or a pipeline
    stage's n_layers / P."""
    w = params["layers"]["attn_norm"]
    return (w.q if isinstance(w, QTensor) else w).shape[0]


def layer_params(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked layer weights (views, no copies)."""
    return {name: w.layer(i) if isinstance(w, QTensor) else w[i]
            for name, w in params["layers"].items()}


def lm_head(params: Params, cfg: ModelConfig, mesh=None,
            rules: AxisRules = INFER_RULES) -> torch.Tensor:
    """[d, V] output projection (the embedding's transpose when tied); under
    tp > 1 this rank's [d, V / tp] columns, gathered over fsdp where `rules`
    cut it there."""
    if cfg.tie_embeddings:
        head = gather_leaf(params["embed"], ("vocab", "embed"), mesh, rules).t()
    else:
        head = gather_leaf(params["lm_head"], ("embed", "vocab"), mesh, rules)
    return as_weight(head, cfg.activation_dtype)


def logits_of(x: torch.Tensor, params: Params, cfg: ModelConfig, mesh=None,
              rules: AxisRules = INFER_RULES, local: bool = False) -> torch.Tensor:
    """Normed hidden states [B, S, d] -> f32 logits [B, S, V]: the head's
    product, all-gathered over the vocabulary under tp > 1 (with
    local=True, this rank's [B, S, V / tp] columns)."""
    out = torch.einsum("bsd,dv->bsv", copy_to(x, mesh), lm_head(params, cfg, mesh, rules))
    return (out if local else all_gather(out, mesh, "tp", dim=-1)).float()


# ------------------------------------------------------------------------- forward

class KVCache(NamedTuple):
    """Stacked-per-layer KV cache: k/v [L, B, max_len, n_kv_heads, head_dim];
    `length` is the current fill (a host int, the same for every row). The
    forward writes new K/V into k/v IN PLACE and returns the same tensors."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device=None, mesh=None) -> KVCache:
    """A zeroed cache; under tp > 1 it holds this rank's kv heads, on a
    pipeline stage its n_layers / P layers."""
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.n_layers // axis_size(mesh, "pp"), batch, max_len,
             cfg.n_kv_heads // axis_size(mesh, "tp"), cfg.head_dim)
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
    token_mask: Optional[torch.Tensor] = None,
    mesh=None,
):
    """One decoder block -> (x, (k, v) cache views if caching else None, the
    MoE aux loss or None for a dense config).

    With a cache, this step's K/V are written into ck/cv [B, max_len, Hkv, hd]
    at cache_len in place, and the queries attend over the filled prefix.
    Under tp > 1 the heads are this rank's (the local weights' shapes), and
    the output projection's partial sums are all-reduced."""
    dt = x.dtype
    h = copy_to(rms_norm(x, lp["attn_norm"], cfg.norm_eps), mesh)
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
    o = all_reduce(torch.einsum("bshk,hkd->bsd", attn, as_weight(lp["wo"], dt)), mesh)
    x = x + o

    down, aux = mlp(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp, cfg, token_mask, mesh)
    return x + down, new_kv, aux


def mlp(h: torch.Tensor, lp: Params, cfg: ModelConfig,
        token_mask: Optional[torch.Tensor] = None, mesh=None):
    """The block's MLP over h [B, S, D] -> (out [B, S, D], the MoE aux loss
    or None): SwiGLU, or the capacity-dispatch MoE over the B*S tokens
    (ray_tpu/models/llama.py:259-272). token_mask [B, S], 1 = a real token
    (MoE only): pads and inactive slots claim no expert capacity. Under
    tp > 1 the hidden units are this rank's, the input's gradient is summed
    over "tp" (copy_to) and the down projection's partial sums are
    all-reduced."""
    dt = h.dtype
    check_tensor_parallel(cfg, mesh)
    if cfg.n_experts > 0:
        b, s, d = h.shape
        y, aux = moe.moe_mlp(h.reshape(b * s, d), lp["router"], lp["w_gate"], lp["w_up"],
                             lp["w_down"], cfg,
                             mask=None if token_mask is None else token_mask.reshape(b * s))
        return y.reshape(b, s, d), aux
    h = copy_to(h, mesh)
    gate = torch.einsum("bsd,df->bsf", h, as_weight(lp["w_gate"], dt))
    up = torch.einsum("bsd,df->bsf", h, as_weight(lp["w_up"], dt))
    down = torch.einsum("bsf,fd->bsd", F.silu(gate) * up, as_weight(lp["w_down"], dt))
    return all_reduce(down, mesh), None


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    return_aux: bool = False,
    token_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real; MoE capacity masking
    mesh=None,
    at: Optional[int] = None,
    rules: AxisRules = INFER_RULES,
    local_logits: bool = False,
):
    """tokens [B, S] -> (logits [B, S, vocab] f32, updated cache or None).
    With `at`, only position `at` goes through the final norm and the head
    (logits [B, 1, vocab]): a prefill keeps one row, so it neither computes
    nor, under tp > 1, all-gathers the others.

    The cache, when given, is updated in place (see KVCache). With
    return_aux=True also returns the MoE load-balancing loss summed over the
    layers (a zero for dense configs). Without a cache each layer goes
    through _maybe_remat. With a `mesh`, params and cache are this rank's
    shards by `rules` (INFER_RULES: tensor-parallel serving; TRAIN_RULES:
    also cut over fsdp, each leaf gathered where it is used), tokens are
    this rank's rows, and every rank returns the whole logits of them, or
    with local_logits=True its [B, S, V / tp] columns. Differentiable
    throughout: the collectives carry their gradients.

    On a mesh with pipeline stages (serving: a cache is required) params and
    cache hold this stage's layers; the stage runs them on the embedding
    (stage 0) or on the previous stage's hidden states, hands its own to the
    next stage, and every stage takes the last stage's rows (those of `at`
    only) to the final norm and the head."""
    if cfg.pipeline_stages > 1 and cache is None:
        raise NotImplementedError("pipeline_stages > 1: ROADMAP A6")
    pp, stage = axis_size(mesh, "pp"), axis_index(mesh, "pp")
    if pp > 1 and cache is None:
        raise NotImplementedError("pipeline stages without a KV cache (training over pp): "
                                  "ROADMAP A6")
    b, s = tokens.shape
    if positions is None:
        start = cache.length if cache is not None else 0
        positions = (torch.arange(s, device=tokens.device) + start)[None, :].expand(b, s)
    axes = param_axes(cfg)
    if stage == 0:
        x = _embed_lookup(gather_leaf(params["embed"], axes["embed"], mesh, rules), tokens,
                          cfg.activation_dtype, mesh)
    else:
        x = pipeline.recv_from_prev((b, s, cfg.d_model), cfg.activation_dtype, tokens.device,
                                    mesh)

    def gathered(lp):  # a layer's leaves joined over fsdp where the rules cut them
        return {name: gather_leaf(w, axes["layers"][name][1:], mesh, rules)
                for name, w in lp.items()}

    if cache is None:
        def body(h, lp):
            h, _, aux = _block(h, gathered(lp), cfg, positions, segment_ids,
                               token_mask=token_mask, mesh=mesh)
            return h, aux

        layer = _maybe_remat(body, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) if return_aux else None
    for i in range(local_layers(params)):
        lp = layer_params(params, i)
        if cache is not None:
            x, _, aux = _block(x, gathered(lp), cfg, positions, segment_ids,
                               (cache.k[i], cache.v[i]), cache.length, token_mask, mesh)
        else:
            x, aux = layer(x, lp)
        if return_aux and aux is not None:
            aux_total = aux_total + aux
    new_cache = None
    if cache is not None:
        new_cache = KVCache(cache.k, cache.v, cache.length + s)
    if stage < pp - 1:
        pipeline.send_to_next(x, mesh)
    if at is not None:
        x = x[:, at:at + 1]
    x = pipeline.from_last_stage(x, mesh)
    x = rms_norm(x, gather_leaf(params["final_norm"], axes["final_norm"], mesh, rules),
                 cfg.norm_eps)
    logits = logits_of(x, params, cfg, mesh, rules, local=local_logits)
    if return_aux:
        return logits, new_cache, aux_total
    return logits, new_cache


def batch_axes(rules: AxisRules) -> Tuple[str, ...]:
    """The mesh axes of the logical "batch" axis (dp, fsdp by TRAIN_RULES)."""
    axes = rules["batch"]
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


def batch_sum(x: torch.Tensor, mesh, rules: AxisRules = TRAIN_RULES) -> torch.Tensor:
    """x summed over every mesh axis of the batch (differentiable: each
    rank's gradient flows to its own part)."""
    for axis in batch_axes(rules):
        x = all_reduce(x, mesh, axis)
    return x


def _vocab_parallel_ll(logits: torch.Tensor, targets: torch.Tensor, mesh) -> torch.Tensor:
    """log p(target) from each rank's [B, S, V / tp] f32 logits columns:
    the row maximum, the sum of exponentials and the target's logit are
    reduced over "tp", and the whole vocabulary is never gathered."""
    v_local = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1), mesh, "tp", op="max")
    sumexp = all_reduce((logits - m[..., None]).exp().sum(dim=-1), mesh, "tp")
    local = targets - axis_index(mesh, "tp") * v_local
    mine = (local >= 0) & (local < v_local)
    tgt = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    tgt = all_reduce(torch.where(mine, tgt, torch.zeros_like(tgt)), mesh, "tp")
    return tgt - (m + sumexp.log())


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            mesh=None, rules: AxisRules = TRAIN_RULES
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (ray_tpu/models/llama.py:437-460). batch:
    tokens [B, S]; optional loss_mask [B, S] and segment_ids [B, S]. Inputs
    are tokens[:, :-1], targets tokens[:, 1:]; the mean runs over the masked
    targets, with a denominator of at least 1.

    With a `mesh`, params are this rank's shards by `rules` and batch is the
    GLOBAL batch, of which the rank computes its rows (the rules' "batch"
    axes); the cross entropy is vocab-parallel over "tp", and Σ(ll·mask)
    and Σmask are summed over the batch axes before the division, so the
    loss and the metrics are the global token mean's, the same on every
    rank (not a mean of the ranks' means)."""
    check_training_mesh(cfg, mesh)
    if mesh is not None:
        batch = {k: shard_view(v, ("batch", None), mesh, rules) for k, v in batch.items()}
    tokens = batch["tokens"]
    seg = batch.get("segment_ids")
    logits, _, aux = forward(params, tokens[:, :-1], cfg,
                             segment_ids=None if seg is None else seg[:, :-1],
                             return_aux=True, mesh=mesh, rules=rules, local_logits=True)
    targets = tokens[:, 1:].long()
    if axis_size(mesh, "tp") > 1:
        ll = _vocab_parallel_ll(logits, targets, mesh)
    else:
        # target logit minus logsumexp == log_softmax gathered at the target,
        # without a second [B, S, vocab] f32 tensor
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[..., None])[..., 0]
        ll = tgt - lse
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask[:, 1:].to(ll.dtype)
    with torch.no_grad():
        denom = batch_sum(mask.sum(), mesh, rules).clamp_min(1.0)
    ce = -batch_sum((ll * mask).sum(), mesh, rules) / denom
    loss = ce + aux
    return loss, {"loss": loss, "ce_loss": ce, "moe_aux_loss": aux, "tokens": denom}
