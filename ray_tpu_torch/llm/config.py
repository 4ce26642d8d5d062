"""LLM engine/server configuration (port of ray_tpu/llm/config.py).

The JAX package's fields that this slice serves, and those that select what
it does not serve yet: the slot KV layout on one device with whole-prompt
prefill. The rest raises NotImplementedError naming its ROADMAP item at
construction.
The defaults the JAX package reads from its knob registry are constants here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch.models.config import ModelConfig, get_config

# the JAX package's knob defaults (ray_tpu/knobs.py), fixed for the port
MAX_NUM_SEQS = 8
MAX_MODEL_LEN = 1024
FUSED_STEPS = 0  # 0 = auto-tune the fused burst width
FUSED_STEPS_MAX = 32
FUSED_SYNC_TARGET = 0.15
ENGINE_IDLE_WAIT_S = 0.05


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling controls (reference vLLM SamplingParams surface)."""

    max_tokens: int = 64
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    stop_token_ids: Optional[List[int]] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")


@dataclasses.dataclass
class LLMConfig:
    """Model + engine settings for ``TorchLLMEngine`` / ``LLMServer``.

    ``model_id`` is the served-model name (OpenAI ``model`` field);
    ``model_source`` is a registry name (e.g. "byte-tiny", "llama3-8b") or a
    ModelConfig. Weights are stored in ``dtype`` once the engine starts.
    """

    model_id: str = "llama"
    model_source: Union[str, Any] = "byte-tiny"
    max_num_seqs: int = MAX_NUM_SEQS  # decode slots (batching width)
    max_model_len: int = MAX_MODEL_LEN  # KV capacity per slot
    prefill_buckets: Optional[List[int]] = None  # pad-to lengths; default powers of 2
    dtype: str = "bfloat16"
    kv_layout: str = "slot"  # "paged": ROADMAP A2
    prefill_chunk: Optional[int] = None  # ROADMAP A2
    # fused decode burst width; None = FUSED_STEPS (0 = auto-tune)
    num_decode_steps: Optional[int] = None
    num_speculative_tokens: int = 0  # ROADMAP A2
    speculative: Optional[Any] = None  # ROADMAP A2
    quantization: Optional[str] = None  # ROADMAP A3
    tensor_parallel_size: int = 1  # > 1: ROADMAP A6
    data_parallel_size: int = 1
    expert_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    tokenizer: str = "byte"  # "byte" | "hf:<name-or-path>"
    engine_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)  # ModelConfig overrides

    def __post_init__(self):
        if self.kv_layout == "paged":
            raise NotImplementedError("kv_layout='paged' (paged KV, prefix cache): "
                                      "ROADMAP A2")
        if self.kv_layout != "slot":
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.num_speculative_tokens or self.speculative is not None:
            raise NotImplementedError("speculative decoding: ROADMAP A2")
        if self.quantization:
            raise NotImplementedError("weight quantization: ROADMAP A3")
        if self.prefill_chunk:
            raise NotImplementedError("chunked prefill: ROADMAP A2")
        for name in ("tensor_parallel_size", "data_parallel_size",
                     "expert_parallel_size", "pipeline_parallel_size"):
            if getattr(self, name) != 1:
                raise NotImplementedError(f"{name} > 1: ROADMAP A6")

    def resolve_decode_steps(self) -> int:
        """Configured fused burst width; 0 means auto-tune (engine-side)."""
        if self.num_decode_steps is not None:
            return max(0, int(self.num_decode_steps))
        return FUSED_STEPS

    def resolve_model_config(self) -> ModelConfig:
        if isinstance(self.model_source, ModelConfig):
            return self.model_source
        if os.path.isdir(str(self.model_source)):
            raise NotImplementedError("loading a checkpoint directory: ROADMAP A5")
        return get_config(self.model_source, **self.engine_kwargs)

    def buckets(self) -> List[int]:
        if self.prefill_buckets:
            return sorted(self.prefill_buckets)
        out, b = [], 16
        while b < self.max_model_len:
            out.append(b)
            b *= 2
        out.append(self.max_model_len)
        return out
