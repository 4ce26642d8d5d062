"""HF-format checkpoints: safetensors <-> the port's llama parameter dict
(port of ray_tpu/models/checkpoint.py).

A checkpoint is a local directory in the HF transformers Llama or Mixtral
layout: config.json and one or more .safetensors files (shards listed in
model.safetensors.index.json, or every .safetensors file of the directory),
with torch ``Linear`` weights stored (out_features, in_features). Nothing is
downloaded. Files are read and written by ``models/safetensors.py``, which
needs no package, so F32, F16, BF16 and I8 tensors all load: a bf16 release
reads as it lies (the JAX loader's numpy reader cannot read BF16).

``load_llama_params`` preallocates each leaf on the device in the target
dtype and fills it one piece at a time: a layer of a projection or a norm,
one expert of a layer's stack, or a whole embedding or head. A piece moves to
the device as it lies in the file (a view of the file's mapping) and is
transposed and cast there, so host and device each hold one piece beside the
model, where the JAX loader stacks every layer of a leaf on the host. The
values are the JAX loader's. With ``quantize_int8`` each piece of a layer
matmul (and the untied head) is cast to the dtype and quantized into the
preallocated int8 leaf as it arrives, bit for bit
``quantize_llama_params(load_llama_params(...))``, without the float model
ever existing whole.

``save_llama_params`` writes what the JAX package writes: one
model.safetensors, every tensor in f32 except f16, which stays f16, and
config.json. Each tensor streams from its device in turn.

The device-mesh arguments of the JAX loader (``mesh``, ``rules``) are ROADMAP
A6; the port loads onto one device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.quant import (LLAMA_QUANT_KEYS, QTensor, empty_qtensor,
                                     layer_contract_axis, quantize)

from . import llama
from .config import ModelConfig
from .safetensors import SafeFile, save_file

Params = Dict[str, Any]


# ----------------------------------------------------------------- config.json

def config_from_hf(source_dir: str, **overrides) -> ModelConfig:
    """Map an HF transformers LlamaConfig (config.json) onto ModelConfig."""
    with open(os.path.join(source_dir, "config.json")) as f:
        hf = json.load(f)
    fields = dict(
        name=hf.get("_name_or_path") or os.path.basename(os.path.normpath(source_dir)),
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_ff=hf["intermediate_size"],
        # missing keys take the HF transformers LlamaConfig defaults, not the
        # registry's: a Llama-2-era config.json omits rope_theta and means 10000.0
        max_seq_len=hf.get("max_position_embeddings", 2048),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    # Mixtral-style sparse MoE (num_local_experts in MixtralConfig). Softmax
    # over all E, top-k, renormalized to 1 equals Mixtral's softmax over the
    # top-k logits; top-1 needs the explicit renorm flag. Mixtral has no
    # capacity (dropless), so the faithful default is capacity_factor = E/k,
    # which covers every token routed to one expert. A round-tripped
    # checkpoint carries its trained factor in config.json instead.
    if hf.get("num_local_experts", 0):
        # only Mixtral's layout and gating are wired: another family with
        # num_local_experts (e.g. Phi-MoE) would fail later at weight load
        # with an opaque missing-tensor error
        model_type = hf.get("model_type", "")
        if model_type != "mixtral":
            raise ValueError(
                f"unsupported MoE checkpoint: model_type {model_type!r} with "
                f"num_local_experts={hf['num_local_experts']}; only "
                "Mixtral-style sparse MoE (model_type 'mixtral') is supported"
            )
        e = int(hf["num_local_experts"])
        k = int(hf.get("num_experts_per_tok", 2))
        fields["n_experts"] = e
        fields["moe_top_k"] = k
        fields["moe_top1_renorm"] = bool(hf.get("moe_top1_renorm", True))
        fields["moe_capacity_factor"] = float(hf.get("moe_capacity_factor", e / k))
    fields.update(overrides)
    return ModelConfig(**fields)


def config_to_hf(cfg: ModelConfig) -> Dict[str, Any]:
    moe = cfg.n_experts > 0
    extra = (
        # moe_capacity_factor / moe_top1_renorm are extension keys (HF ignores
        # them): they keep the trained dispatch through a round trip instead
        # of the dropless Mixtral defaults
        {"num_local_experts": cfg.n_experts, "num_experts_per_tok": cfg.moe_top_k,
         "moe_capacity_factor": cfg.moe_capacity_factor,
         "moe_top1_renorm": cfg.moe_top1_renorm}
        if moe else {}
    )
    return {
        "architectures": ["MixtralForCausalLM" if moe else "LlamaForCausalLM"],
        "model_type": "mixtral" if moe else "llama",
        **extra,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
    }


# ---------------------------------------------------------------- tensor index

class _ShardedReader:
    """name -> tensor across one or many .safetensors files, each mapped once."""

    def __init__(self, source_dir: str):
        self._dir = source_dir
        self._files: Dict[str, SafeFile] = {}
        self._key_to_file: Dict[str, str] = {}
        index_path = os.path.join(source_dir, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                weight_map = json.load(f)["weight_map"]
            for key, fname in weight_map.items():
                self._key_to_file[key] = os.path.join(source_dir, fname)
        else:
            files = sorted(os.path.join(source_dir, f) for f in os.listdir(source_dir)
                           if f.endswith(".safetensors"))
            if not files:
                raise FileNotFoundError(f"no .safetensors files in {source_dir}")
            for path in files:
                for key in self._open(path).keys():
                    self._key_to_file[key] = path

    def _open(self, path: str) -> SafeFile:
        if path not in self._files:
            self._files[path] = SafeFile(path)
        return self._files[path]

    def get(self, name: str) -> torch.Tensor:
        """The tensor as stored, on the file's mapping."""
        try:
            path = self._key_to_file[name]
        except KeyError:
            raise KeyError(f"{name} is not in the checkpoint {self._dir}") from None
        return self._open(path).get(name)


# -------------------------------------------------------------------- mapping
# HF torch Linear stores weight as (out_features, in_features); the port's
# leaves contract inputs on their leading axis, so every projection transposes.

# (index into the leaf, tensor name in the checkpoint, file layout -> leaf layout)
Piece = Tuple[Tuple[int, ...], str, Callable[[torch.Tensor], torch.Tensor]]


def _leaf_pieces(cfg: ModelConfig) -> Dict[str, List[Piece]]:
    """Each leaf's pieces: "embed", "final_norm", "lm_head" and
    "layers/<field>"; an expert stack has one piece per (layer, expert)."""
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads

    def same(t):
        return t

    def t_(t):
        return t.T

    def heads(n):
        return lambda t: t.T.reshape(d, n, hd)

    layer = {
        "attn_norm": ("input_layernorm.weight", same),
        "mlp_norm": ("post_attention_layernorm.weight", same),
        "wq": ("self_attn.q_proj.weight", heads(nh)),
        "wk": ("self_attn.k_proj.weight", heads(nkv)),
        "wv": ("self_attn.v_proj.weight", heads(nkv)),
        "wo": ("self_attn.o_proj.weight", lambda t: t.T.reshape(nh, hd, d)),
    }
    experts = {}
    if cfg.n_experts > 0:
        # Mixtral: block_sparse_moe.gate (the router, [E, D]) and
        # experts.{e}.w1 / w3 / w2 (gate / up / down) in Linear orientation
        layer["router"] = ("block_sparse_moe.gate.weight", t_)
        experts = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}
    else:
        layer.update({"w_gate": ("mlp.gate_proj.weight", t_),
                      "w_up": ("mlp.up_proj.weight", t_),
                      "w_down": ("mlp.down_proj.weight", t_)})
    out: Dict[str, List[Piece]] = {
        "embed": [((), "model.embed_tokens.weight", same)],
        "final_norm": [((), "model.norm.weight", same)],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = [((), "lm_head.weight", t_)]
    for field, (suffix, fn) in layer.items():
        out[f"layers/{field}"] = [((i,), f"model.layers.{i}.{suffix}", fn)
                                  for i in range(cfg.n_layers)]
    for field, w in experts.items():
        out[f"layers/{field}"] = [
            ((i, j), f"model.layers.{i}.block_sparse_moe.experts.{j}.{w}.weight", t_)
            for i in range(cfg.n_layers) for j in range(cfg.n_experts)]
    return out


@torch.no_grad()
def load_llama_params(source_dir: str, cfg: Optional[ModelConfig] = None, device=None,
                      dtype: torch.dtype = torch.bfloat16, *,
                      quantize_int8: bool = False) -> Params:
    """Stream an HF Llama / Mixtral safetensors checkpoint into the port's
    parameter dict on `device` (CUDA unless "cpu" is asked for), in `dtype`.

    cfg defaults to the directory's config.json. quantize_int8=True stores the
    layer matmuls and an untied head as int8 QTensors, each piece cast to
    `dtype` and quantized as it arrives."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = config_from_hf(source_dir)
    rd = _ShardedReader(source_dir)
    shapes = llama.param_shapes(cfg)
    layer_keys = shapes["layers"]

    def fill(name: str, shape, pieces: List[Piece], axis: Optional[int]):
        dst = (torch.empty(shape, dtype=dtype, device=dev) if axis is None
               else empty_qtensor(shape, axis, dev))
        for index, key, to_leaf in pieces:
            w = to_leaf(rd.get(key).to(dev))
            want = tuple(shape[len(index):])
            if tuple(w.shape) != want:
                raise ValueError(f"{key}: shape {tuple(w.shape)} does not fit {name} "
                                 f"{tuple(shape)} of the config ({want} expected)")
            if axis is None:
                dst[index].copy_(w)
            else:
                # the piece as read is dropped once cast; its contraction axis
                # is its first: d_in of a layer slice, of one expert, or of the head
                w = w.to(dtype)
                dst.q[index], dst.s[index] = quantize(w, 0)
        return dst

    pieces = _leaf_pieces(cfg)
    params: Params = {"layers": {}}
    for name, shape in shapes.items():
        if name == "layers":
            continue
        axis = 0 if quantize_int8 and name == "lm_head" else None
        params[name] = fill(name, shape, pieces[name], axis)
    for field, shape in layer_keys.items():
        axis = (layer_contract_axis(field, layer_keys)
                if quantize_int8 and field in LLAMA_QUANT_KEYS else None)
        params["layers"][field] = fill(f"layers/{field}", shape,
                                       pieces[f"layers/{field}"], axis)
    return params


def hf_state_dict(params: Params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors under their HF names, in HF's order (the
    embedding, each layer, the final norm, the head), each a view of its leaf
    in torch Linear's (out, in) layout: nothing is copied."""
    for leaf in llama.tree_leaves(params):
        if isinstance(leaf, QTensor):
            raise ValueError("int8 QTensor leaves have no HF layout; save the float weights")
    d = cfg.d_model
    lyr = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"]}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        out[pre + "self_attn.q_proj.weight"] = lyr["wq"][i].reshape(d, -1).T
        out[pre + "self_attn.k_proj.weight"] = lyr["wk"][i].reshape(d, -1).T
        out[pre + "self_attn.v_proj.weight"] = lyr["wv"][i].reshape(d, -1).T
        out[pre + "self_attn.o_proj.weight"] = lyr["wo"][i].reshape(-1, d).T
        if cfg.n_experts > 0:
            moe_pre = pre + "block_sparse_moe."
            out[moe_pre + "gate.weight"] = lyr["router"][i].T
            for j in range(cfg.n_experts):
                ex = moe_pre + f"experts.{j}."
                out[ex + "w1.weight"] = lyr["w_gate"][i, j].T
                out[ex + "w3.weight"] = lyr["w_up"][i, j].T
                out[ex + "w2.weight"] = lyr["w_down"][i, j].T
        else:
            out[pre + "mlp.gate_proj.weight"] = lyr["w_gate"][i].T
            out[pre + "mlp.up_proj.weight"] = lyr["w_up"][i].T
            out[pre + "mlp.down_proj.weight"] = lyr["w_down"][i].T
        out[pre + "input_layernorm.weight"] = lyr["attn_norm"][i]
        out[pre + "post_attention_layernorm.weight"] = lyr["mlp_norm"][i]
    out["model.norm.weight"] = params["final_norm"]
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"].T
    return out


def save_llama_params(params: Params, cfg: ModelConfig, out_dir: str) -> str:
    """Write the parameter dict as an HF-layout safetensors checkpoint plus
    config.json: every tensor in f32, except f16, which stays f16."""
    if cfg.n_experts > 0 and not cfg.moe_top1_renorm and cfg.moe_top_k == 1:
        import warnings

        # HF ignores the extension keys: MixtralForCausalLM renormalizes the
        # single gate to 1.0, while this model gates by the raw top-1 prob
        warnings.warn(
            "exporting a Switch-gated MoE (moe_top_k=1, moe_top1_renorm=False) "
            "in Mixtral layout: transformers will renormalize the gate to 1.0 "
            "and produce different logits; only ray_tpu's loader reproduces "
            "the trained semantics", stacklevel=2)
    os.makedirs(out_dir, exist_ok=True)
    tensors = hf_state_dict(params, cfg)
    dtypes = {name: t.dtype if t.dtype in (torch.float32, torch.float16) else torch.float32
              for name, t in tensors.items()}
    save_file(tensors, os.path.join(out_dir, "model.safetensors"), dtypes=dtypes)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=2)
    return out_dir


def looks_like_checkpoint_dir(path: Any) -> bool:
    return (isinstance(path, str) and os.path.isdir(path)
            and os.path.exists(os.path.join(path, "config.json")))
