"""The train step: loss -> grads -> clip + AdamW (port of ray_tpu/train/step.py).

``make_optimizer`` -> ``init_state`` -> ``make_train_step`` is the JAX
package's training path with the same arguments and defaults. PyTorch runs
eagerly, so the step is a plain function: autograd takes the gradients
(attention's through the flash kernels' Function on CUDA), and the optimizer
updates the parameters and moments in place (``optim.py``). Parameters are
f32; the model casts them to the activation dtype at use.

``init_state(checkpoint_dir=...)`` warm-starts from a local HF-layout
checkpoint (models/checkpoint.py), loaded in f32 on the step's device. Parts
of the JAX module the port does not run yet raise NotImplementedError naming
their ROADMAP item: a device mesh (A6) and the grad-sync modes (A8).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import checkpoint, llama
from ray_tpu_torch.models.config import ModelConfig, torch_dtype

from . import optim


class TrainState(NamedTuple):
    """step: updates made (host int); params: the llama parameter dict (f32
    leaves that require grad); opt_state: optim.AdamWState over
    llama.tree_leaves(params)."""

    step: int
    params: llama.Params
    opt_state: optim.AdamWState


def make_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    mu_dtype: Optional[Union[str, torch.dtype]] = None,
) -> optim.Optimizer:
    """clip_by_global_norm(grad_clip) then adamw over a warmup-cosine schedule
    from 0 to learning_rate and back to 0 at max(total_steps, warmup_steps +
    1). mu_dtype: dtype of Adam's first moment (e.g. bfloat16)."""
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    if isinstance(mu_dtype, str):
        mu_dtype = torch_dtype(mu_dtype)
    return optim.Optimizer(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                           grad_clip=grad_clip, mu_dtype=mu_dtype)


def _not_yet(mesh, sync) -> None:
    if mesh is not None:
        raise NotImplementedError("a device mesh (model parallel training): ROADMAP A6")
    if sync is not None:
        raise NotImplementedError("grad-sync modes (sync=...): ROADMAP A8")


def init_state(cfg: ModelConfig, tx: optim.Optimizer, *, seed: int = 0, device=None,
               checkpoint_dir: Optional[str] = None, mesh: Any = None,
               sync: Any = None) -> TrainState:
    """Fresh TrainState: llama.init(cfg, seed) in f32 on `device` (the CUDA
    device unless "cpu" is asked for) and the optimizer's zero state. With
    checkpoint_dir the parameters are that checkpoint's instead, in f32 (a
    warm start: fine-tuning from a released model)."""
    _not_yet(mesh, sync)
    if checkpoint_dir is not None:
        params = checkpoint.load_llama_params(checkpoint_dir, cfg, device=device,
                                              dtype=torch.float32)
    else:
        params = llama.init(cfg, seed=seed, device=device, dtype=torch.float32)
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(0, params, tx.init(leaves))


def _copy(state: TrainState) -> TrainState:
    params = llama.tree_unflatten(
        state.params, [p.detach().clone().requires_grad_(True)
                       for p in llama.tree_leaves(state.params)])
    opt = state.opt_state
    return TrainState(state.step, params, optim.AdamWState(
        opt.count, [m.clone() for m in opt.mu], [n.clone() for n in opt.nu]))


def make_train_step(
    cfg: ModelConfig,
    tx: optim.Optimizer,
    loss_fn: Optional[Callable] = None,
    donate: bool = True,
    sync: Any = None,
    *,
    device=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, batch) -> (state, metrics).

    metrics are loss_fn's (loss, ce_loss, moe_aux_loss, tokens) plus
    grad_norm, the global norm of the unclipped gradients, all as 0-d tensors
    on the device: the step reads nothing back to the host. With donate=True
    (the default, as in JAX) the step updates the state's parameters and
    moments IN PLACE and returns them; with donate=False it works on a copy
    and leaves the given state as it was. The step runs on `device` (the CUDA
    device unless "cpu" is asked for) and raises for a state elsewhere."""
    _not_yet(None, sync)
    loss_fn = loss_fn or llama.loss_fn
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = llama.tree_leaves(state.params)
        if any(p.device.type != dev.type for p in leaves):
            raise ValueError(f"train state is not on the step's device {dev}")
        if not donate:
            state = _copy(state)
            leaves = llama.tree_leaves(state.params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, aux = loss_fn(state.params, batch, cfg)
            grads = list(torch.autograd.grad(loss, leaves))
        metrics = {name: val.detach() for name, val in aux.items()}
        opt_state, metrics["grad_norm"] = tx.update_(grads, state.opt_state, leaves)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step
