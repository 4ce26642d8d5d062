"""Token sampling with per-slot parameters (port of ray_tpu/llm/sampling.py).

Continuous batching samples for all active slots at once, each with its own
temperature/top-p/top-k, so the sampler is one vectorised function over
[B, V] logits. Randomness comes from an explicit ``torch.Generator``; its
numbers are not jax.random's, so sampled tokens match the JAX package
only in distribution (greedy rows match exactly).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e10


def _apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask logits outside each row's top-k. top_k[B] int, 0 = disabled."""
    v = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, v), torch.full_like(top_k, v))
    kth = torch.gather(sorted_logits, -1, (k - 1).long()[:, None])
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering per row. top_p[B] float, 1.0 = disabled."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens while cumulative prob (exclusive) < top_p; always keep the first
    keep = (cum - probs) < top_p[:, None]
    cutoff = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))).amin(dim=-1)
    return torch.where(logits < cutoff[:, None], torch.full_like(logits, NEG_INF), logits)


def sample(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] (int64). temperature==0 rows are greedy.

    Sampling is Gumbel-max over the filtered, temperature-scaled logits (the
    categorical draw jax.random.categorical makes)."""
    greedy = torch.argmax(logits, dim=-1)
    temp = temperature.clamp_min(1e-6)[:, None]
    scaled = logits / temp
    scaled = _apply_top_k(scaled, top_k)
    scaled = _apply_top_p(scaled, top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
