"""Transformer model configs + registry (port of ray_tpu/models/config.py).

Same dataclass fields and the same registry entries as the JAX package, so a
config name means the same architecture in both. Sizes follow the public
Llama-2/-3 architecture descriptions (RMSNorm, RoPE, GQA, SwiGLU, untied or tied
embeddings). ``activation_dtype`` returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' -> torch.bfloat16."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r} (expected one of {sorted(_DTYPES)})")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation dtype
    # training-only fields, kept so configs round-trip with the JAX package
    remat: bool = True
    remat_policy: str = "full"  # full | dots | dots_no_batch | none
    scan_layers: bool = True  # layer weights stacked on a leading [L] axis
    # attention backend: auto|flash|chunked|reference (ring/ulysses: ROADMAP A6)
    attention_impl: str = "auto"
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    # mixture-of-experts (0 = dense): models/moe.py
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_top1_renorm: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + norms)."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        attn = self.d_model * self.head_dim * (2 * self.n_heads + 2 * self.n_kv_heads)
        mlp = 3 * self.d_model * self.d_ff
        norms = 2 * self.d_model
        return emb + self.n_layers * (attn + mlp + norms) + self.d_model


_REGISTRY: Dict[str, ModelConfig] = {}


def register_config(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


register_config(ModelConfig(
    name="test-tiny", vocab_size=256, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, d_ff=128, max_seq_len=128, dtype="float32", scan_layers=True))
register_config(ModelConfig(
    # tiny serving-test model whose vocab covers the byte-level tokenizer (259 ids)
    name="byte-tiny", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, d_ff=128, max_seq_len=256, dtype="float32", scan_layers=True))
register_config(ModelConfig(
    name="llama-500m", vocab_size=32000, d_model=1536, n_layers=12, n_heads=12,
    n_kv_heads=6, d_ff=4096, max_seq_len=2048, rope_theta=500000.0))
register_config(ModelConfig(
    name="llama-1b", vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
    n_kv_heads=8, d_ff=5632, max_seq_len=2048, rope_theta=500000.0))
register_config(ModelConfig(
    # llama3-8b layer geometry at two layers
    name="llama8b-geom2", vocab_size=32000, d_model=4096, n_layers=2, n_heads=32,
    n_kv_heads=8, d_ff=14336, max_seq_len=2048, rope_theta=500000.0))
register_config(ModelConfig(
    name="llama3-8b", vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
    n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=500000.0))
register_config(ModelConfig(
    name="llama3-70b", vocab_size=128256, d_model=8192, n_layers=80, n_heads=64,
    n_kv_heads=8, d_ff=28672, max_seq_len=8192))
register_config(ModelConfig(
    name="moe-tiny", vocab_size=256, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, d_ff=96, max_seq_len=128, dtype="float32", scan_layers=True,
    n_experts=4, moe_top_k=2))
register_config(ModelConfig(
    # Mixtral-8x7B architecture description (public): 8 experts, top-2 routing
    name="mixtral-8x7b", vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
    n_kv_heads=8, d_ff=14336, max_seq_len=32768, rope_theta=1e6, n_experts=8,
    moe_top_k=2))
register_config(ModelConfig(
    name="llama2-7b", vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
    n_kv_heads=32, d_ff=11008, max_seq_len=4096, rope_theta=10000.0))
