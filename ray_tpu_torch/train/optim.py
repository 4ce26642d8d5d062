"""Optax's schedule, clipping and AdamW, written out on tensors.

``make_optimizer`` in ray_tpu/train/step.py chains ``optax.clip_by_global_norm``
and ``optax.adamw`` over ``optax.warmup_cosine_decay_schedule``. This module
keeps its own copy of those formulas (the port imports no optax) and
reproduces them step for step:

- the learning rate of an update is the schedule at the count *before* the
  update (so with a warm-up from 0 the first update has lr = 0, and weight
  decay does nothing either);
- bias correction uses count + 1; the denominator is sqrt(nu_hat) + eps with
  no eps inside the root;
- weight decay is added to the Adam direction before the scaling by -lr, and
  applies to every leaf (norms and embeddings included);
- clipping leaves the gradients unchanged when their global norm is below
  the limit, else scales them by limit / norm, with no epsilon (unlike
  ``torch.nn.utils.clip_grad_norm_``);
- ``mu_dtype`` stores the first moment in that dtype. The update computes
  in f32 and uses the new moment before it is cast back; as in optax's
  jitted update, a bf16 moment is decayed by b1 rounded to bf16 (0.8984375
  for 0.9: optax multiplies it by a weakly typed Python float).

Counts are host integers: PyTorch runs eagerly and the host knows how many
updates it made, so the learning rate and the bias corrections are host
floats, computed in float32 as JAX computes them. The update itself runs on
the parameters' device with ``torch._foreach_*`` ops (memory-bound
elementwise work, which the JAX package leaves to XLA outside any kernel) and
updates the parameters and moments in place. It never reads a value back from
the device. Its temporaries (the bias-corrected moments) are made for a group
of leaves at a time, of at most UPDATE_GROUP_BYTES unless one leaf is larger,
so the update holds the parameters, gradients and moments plus two of the
largest group, not two more copies of the model (3.16B f32 parameters of a
2-layer Mixtral hold 47 GiB with their moments before any temporary).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]

UPDATE_GROUP_BYTES = 1 << 30  # parameter bytes per group of the update's temporaries


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine down to end_value at
    decay_steps. decay_steps includes the warm-up."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:  # a warm-up of 0 steps is never taken
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(cos_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha)))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d f32 tensor."""
    norms = torch._foreach_norm(tensors)
    return torch.linalg.vector_norm(torch.stack(norms).float())


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g unchanged when ||g|| < max_norm,
    else g / ||g|| * max_norm. Returns ||g|| (before clipping)."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class AdamWState(NamedTuple):
    """count: updates made (host int); mu, nu: moments, one per parameter
    leaf, in the order of the parameter list."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw_init(params: List[torch.Tensor],
               mu_dtype: Optional[torch.dtype] = None) -> AdamWState:
    mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    return AdamWState(0, mu, nu)


@torch.no_grad()
def adamw_update_(grads: List[torch.Tensor], state: AdamWState,
                  params: List[torch.Tensor], *, learning_rate: Schedule,
                  b1: float, b2: float, eps: float = 1e-8,
                  weight_decay: float = 1e-4) -> AdamWState:
    """optax.adamw(learning_rate, b1, b2, eps, eps_root=0, weight_decay) in
    place: updates `params` and the state's moments and returns the state with
    count + 1. The grads are read, not changed."""
    f32 = np.float32
    count = state.count + 1
    lr = learning_rate(state.count)
    bc1 = float(f32(1) - f32(b1) ** f32(count))
    bc2 = float(f32(1) - f32(b2) ** f32(count))
    for lo, hi in _groups(params):
        _adamw_group_(grads[lo:hi], state.mu[lo:hi], state.nu[lo:hi], params[lo:hi],
                      lr=lr, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay)
    return AdamWState(count, state.mu, state.nu)


def _groups(params: List[torch.Tensor]) -> List[Tuple[int, int]]:
    """[lo, hi) runs of consecutive leaves of at most UPDATE_GROUP_BYTES each
    (a larger leaf alone)."""
    out, lo, size = [], 0, 0
    for i, p in enumerate(params):
        nbytes = p.nelement() * p.element_size()
        if i > lo and size + nbytes > UPDATE_GROUP_BYTES:
            out.append((lo, i))
            lo, size = i, 0
        size += nbytes
    if lo < len(params):
        out.append((lo, len(params)))
    return out


def _adamw_group_(grads, mu, nu, params, *, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """The AdamW update of one group of leaves, in place. Every op is
    elementwise, so a group gets the bits the whole list would."""
    if all(m.dtype == g.dtype for m, g in zip(mu, grads)):
        torch._foreach_mul_(mu, b1)
        mu32 = mu
    else:  # optax's jitted update: f32 math, with b1 rounded to mu's dtype
        mu32 = [m.to(g.dtype).mul_(float(torch.tensor(b1, dtype=m.dtype)))
                for m, g in zip(mu, grads)]
    torch._foreach_add_(mu32, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    upd = torch._foreach_div(mu32, bc1)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(upd, denom)
    del denom
    if weight_decay:
        torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)
    for m, m32 in zip(mu, mu32):
        if m is not m32:
            m.copy_(m32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm then adamw, as optax.chain builds them in
    ray_tpu/train/step.py:make_optimizer."""

    learning_rate: Schedule
    b1: float
    b2: float
    weight_decay: float
    grad_clip: float
    eps: float = 1e-8
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return adamw_init(params, self.mu_dtype)

    def update_(self, grads: List[torch.Tensor], state: AdamWState,
                params: List[torch.Tensor]) -> Tuple[AdamWState, torch.Tensor]:
        """One update in place (grads are clipped in place too). Returns the
        new state and the global norm of the unclipped grads."""
        norm = clip_by_global_norm_(grads, self.grad_clip)
        state = adamw_update_(grads, state, params, learning_rate=self.learning_rate,
                              b1=self.b1, b2=self.b2, eps=self.eps,
                              weight_decay=self.weight_decay)
        return state, norm
