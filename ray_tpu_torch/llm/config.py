"""LLM engine/server configuration (port of ray_tpu/llm/config.py).

The JAX package's fields that the port serves, and those that select what
it does not serve yet: the slot and paged KV layouts (with the prefix cache)
on one device, with whole-prompt or chunked prefill, n-gram speculative
decoding and int8 weights (W8A16), for dense and mixture-of-experts models
(``engine_kwargs`` overrides the model config, e.g. its
``moe_capacity_factor``), from a registry name, a ModelConfig or a local
HF-layout checkpoint directory (models/checkpoint.py). The rest raises NotImplementedError naming
its ROADMAP item at construction. The JAX engine's checks of the paged,
chunked, speculative and quantization settings (ray_tpu/llm/engine.py:283-307)
run here, at construction, before any weight is built, with the same errors.
The defaults the JAX package reads from its knob registry are constants here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch.models import checkpoint
from ray_tpu_torch.models.config import ModelConfig, get_config

# the JAX package's knob defaults (ray_tpu/knobs.py), fixed for the port
MAX_NUM_SEQS = 8
MAX_MODEL_LEN = 1024
FUSED_STEPS = 0  # 0 = auto-tune the fused burst width
FUSED_STEPS_MAX = 32
FUSED_SYNC_TARGET = 0.15
ENGINE_IDLE_WAIT_S = 0.05
# cached-token floor of the prefix cache's pay-or-skip gate; 0 = auto
PREFIX_MIN_HIT_TOKENS = 0


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
class SpecConfig:
    """First-class speculative-decoding mode (reference vLLM SpeculativeConfig).

    Composes with fused multi-step decode: each fused window proposes and
    verifies ``num_tokens`` drafts on the device, so per host sync the engine
    emits between K and K*(num_tokens+1) tokens. ``method`` is the proposer;
    only "ngram" (prompt lookup) is implemented."""

    num_tokens: int = 4
    method: str = "ngram"
    ngram_max: int = 3  # longest trailing n-gram the proposer matches

    def __post_init__(self):
        if self.num_tokens < 1:
            raise ValueError("SpecConfig.num_tokens must be >= 1")
        if self.ngram_max < 1:
            raise ValueError("SpecConfig.ngram_max must be >= 1")


@dataclasses.dataclass
class LLMConfig:
    """Model + engine settings for ``TorchLLMEngine`` / ``LLMServer``.

    ``model_id`` is the served-model name (OpenAI ``model`` field);
    ``model_source`` is a registry name (e.g. "byte-tiny", "llama3-8b"), a
    ModelConfig, or a local checkpoint directory whose weights the engine
    loads at start. Weights are stored in ``dtype`` once the engine starts.
    """

    model_id: str = "llama"
    model_source: Union[str, Any] = "byte-tiny"
    max_num_seqs: int = MAX_NUM_SEQS  # decode slots (batching width)
    max_model_len: int = MAX_MODEL_LEN  # KV capacity per slot
    prefill_buckets: Optional[List[int]] = None  # pad-to lengths; default powers of 2
    dtype: str = "bfloat16"
    # "slot": max_model_len positions reserved per slot; "paged": one shared
    # pool of kv_block_size-token blocks with per-slot block tables
    kv_layout: str = "slot"
    kv_block_size: int = 16
    # total pool blocks; None = the slot layout's token capacity
    num_kv_blocks: Optional[int] = None
    # share full prompt blocks across requests (vLLM automatic prefix caching)
    enable_prefix_caching: bool = True
    # prompts longer than this prefill in chunks of it; None = whole prompt
    prefill_chunk: Optional[int] = None
    # fused decode burst width; None = FUSED_STEPS (0 = auto-tune)
    num_decode_steps: Optional[int] = None
    # speculative decoding (vLLM ngram / prompt lookup): up to this many
    # drafts a step, verified in one forward; 0 = off
    num_speculative_tokens: int = 0
    speculative_method: str = "ngram"
    ngram_prompt_lookup_max: int = 3
    # a SpecConfig (or its dict form) overrides the three fields above
    speculative: Optional[Union[SpecConfig, Dict[str, Any]]] = None
    # None, or "int8": per-output-channel int8 weights, bf16 activations (W8A16)
    quantization: Optional[str] = None
    tensor_parallel_size: int = 1  # > 1: ROADMAP A6
    data_parallel_size: int = 1
    expert_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    tokenizer: str = "byte"  # "byte" | "hf:<name-or-path>"
    accelerator_type: Optional[str] = None
    # the serve builders' replica options: num_replicas, max_ongoing_requests,
    # ray_actor_options (llm/server.py build_openai_app)
    deployment_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    engine_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)  # ModelConfig overrides

    def __post_init__(self):
        if self.kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.speculative is not None:
            sp = self.speculative
            if isinstance(sp, dict):
                sp = self.speculative = SpecConfig(**sp)
            self.num_speculative_tokens = sp.num_tokens
            self.speculative_method = sp.method
            self.ngram_prompt_lookup_max = sp.ngram_max
        if self.num_speculative_tokens and self.speculative_method != "ngram":
            raise NotImplementedError(
                f"speculative_method {self.speculative_method!r}: only "
                "'ngram' (prompt lookup) is implemented")
        if self.quantization and self.quantization != "int8":
            raise ValueError(f"unknown quantization {self.quantization!r} (supported: int8)")
        for name in ("tensor_parallel_size", "data_parallel_size",
                     "expert_parallel_size", "pipeline_parallel_size"):
            if getattr(self, name) != 1:
                raise NotImplementedError(f"{name} > 1: ROADMAP A6")
        if self.kv_layout == "paged":
            if self.max_model_len % self.kv_block_size:
                raise ValueError("max_model_len must be a multiple of kv_block_size")
            if any(b % self.kv_block_size for b in self.buckets()):
                raise ValueError("every prefill bucket must be a multiple of kv_block_size")
            if self.prefill_chunk and self.prefill_chunk % self.kv_block_size:
                raise ValueError("prefill_chunk must be a multiple of kv_block_size "
                                 "(chunked KV installs block-by-block)")
        if self.prefill_chunk and self.max_model_len % self.prefill_chunk:
            # a chunk-padded prompt never exceeds max_model_len
            raise ValueError("max_model_len must be a multiple of prefill_chunk")

    def resolve_decode_steps(self) -> int:
        """Configured fused burst width; 0 means auto-tune (engine-side)."""
        if self.num_decode_steps is not None:
            return max(0, int(self.num_decode_steps))
        return FUSED_STEPS

    def resolve_model_config(self) -> ModelConfig:
        if isinstance(self.model_source, ModelConfig):
            return self.model_source
        if checkpoint.looks_like_checkpoint_dir(self.model_source):
            # a local HF-layout checkpoint: the architecture from its
            # config.json, the weights loaded by the engine at start
            return checkpoint.config_from_hf(self.model_source, **self.engine_kwargs)
        return get_config(self.model_source, **self.engine_kwargs)

    def resolve_tokenizer_name(self) -> str:
        """The checkpoint's own HF tokenizer when the tokenizer is left at
        "byte" and model_source is a checkpoint directory that ships one."""
        if self.tokenizer != "byte":
            return self.tokenizer
        if checkpoint.looks_like_checkpoint_dir(self.model_source) and any(
            os.path.exists(os.path.join(self.model_source, f))
            for f in ("tokenizer.json", "tokenizer_config.json")
        ):
            return f"hf:{self.model_source}"
        return self.tokenizer

    def buckets(self) -> List[int]:
        if self.prefill_buckets:
            return sorted(self.prefill_buckets)
        out, b = [], 16
        while b < self.max_model_len:
            out.append(b)
            b *= 2
        out.append(self.max_model_len)
        return out
