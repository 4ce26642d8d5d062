"""The train step: loss -> grads -> clip + AdamW (port of ray_tpu/train/step.py).

``make_optimizer`` -> ``init_state`` -> ``make_train_step`` is the JAX
package's training path with the same arguments and defaults. PyTorch runs
eagerly, so the step is a plain function: autograd takes the gradients
(attention's through the flash kernels' Function on CUDA), and the optimizer
updates the parameters and moments in place (``optim.py``). Parameters are
f32; the model casts them to the activation dtype at use.

``init_state(checkpoint_dir=...)`` warm-starts from a local HF-layout
checkpoint (models/checkpoint.py), loaded in f32 on the step's device.

On a device mesh (``parallel.build_mesh``: one process per rank, each
calling the same functions), ``init_state(mesh=)`` gives each rank its
shards of the parameters by ``rules`` (TRAIN_RULES: embed over fsdp; heads,
kv heads, mlp and vocab over tp) and AdamW's moments of those shards, as
JAX's GSPMD lays them out (ZeRO over fsdp). ``make_train_step(mesh=)``
takes the GLOBAL batch on every rank, as JAX's jitted step does; the loss
computes the rank's rows (``llama.loss_fn(mesh=)``: fsdp gathers, Megatron's
f/g pair over tp, a vocab-parallel cross entropy, the global token mean).
After the backward each leaf's gradient is summed over the batch axes that
do not cut it (dp; fsdp's come reduce-scattered from the gathers), the
global norm sums each leaf's squares over the axes that cut it, and AdamW
updates the local shards. The metrics are the global values, the same on
every rank. A MoE model or sp or pp on the mesh (A6) raise
NotImplementedError.

``sync=GradSyncConfig(...)`` (train/grad_sync.py, None reads the
environment as in JAX) makes the dp reduction bucketed and launched during
the backward, int8 block-quantized, and the AdamW update sharded over the
update axes; the step object is grad_sync.GradSyncStep for every config.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ray_tpu_torch.models import checkpoint, llama
from ray_tpu_torch.models.config import ModelConfig, torch_dtype
from ray_tpu_torch.parallel.sharding import TRAIN_RULES, AxisRules

from . import grad_sync, optim


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


def _checked(cfg: ModelConfig, mesh, sync) -> grad_sync.GradSyncConfig:
    sync = grad_sync.resolve(sync)
    grad_sync.check_supported(cfg, mesh, sync)
    llama.check_training_mesh(cfg, mesh)
    return sync


def init_state(cfg: ModelConfig, tx: optim.Optimizer, *, seed: int = 0, device=None,
               checkpoint_dir: Optional[str] = None, mesh: Any = None,
               rules: AxisRules = TRAIN_RULES, sync: Any = None) -> TrainState:
    """Fresh TrainState: llama.init(cfg, seed) in f32 on `device` (the CUDA
    device unless "cpu" is asked for) and the optimizer's zero state. With
    checkpoint_dir the parameters are that checkpoint's instead, in f32 (a
    warm start: fine-tuning from a released model). With a `mesh`, this
    rank's shards of either by `rules` (bit for bit the shard of the whole),
    and the moments of the shards: with sync=GradSyncConfig(sharded_update=
    True), of each shard's update slice (grad_sync.update_dims)."""
    sync = _checked(cfg, mesh, sync)
    if checkpoint_dir is not None:
        params = checkpoint.load_llama_params(checkpoint_dir, cfg, device=device,
                                              dtype=torch.float32, mesh=mesh, rules=rules)
    else:
        params = llama.init(cfg, seed=seed, device=device, dtype=torch.float32, mesh=mesh,
                            rules=rules)
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    if sync.sharded_update and mesh is not None:
        dims = grad_sync.update_dims(cfg, mesh, rules, sync.update_axes)
        leaves = [grad_sync.update_slice(p, mesh, d) for p, d in zip(leaves, dims)]
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
    mesh: Any = None,
    rules: AxisRules = TRAIN_RULES,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, batch) -> (state, metrics).

    metrics are loss_fn's (loss, ce_loss, moe_aux_loss, tokens) plus
    grad_norm, the global norm of the unclipped gradients, all as 0-d tensors
    on the device: the step reads nothing back to the host. With donate=True
    (the default, as in JAX) the step updates the state's parameters and
    moments IN PLACE and returns them; with donate=False it works on a copy
    and leaves the given state as it was. The step runs on `device` (the CUDA
    device unless "cpu" is asked for) and raises for a state elsewhere.

    With a `mesh` (JAX's step reads it from its inputs' shardings; here it
    is named), the state is this rank's shards by `rules` (init_state(mesh=))
    and every rank passes the same global batch; loss_fn is called with
    mesh= and rules=, and the metrics are the global values.

    `sync` (a GradSyncConfig; None reads GradSyncConfig.from_env()) picks
    the grad sync (train/grad_sync.py); under mode="bucketed" loss_fn is
    also given manual=("dp",) and returns its dp replica's own mean."""
    return grad_sync.GradSyncStep(cfg, tx, loss_fn, _checked(cfg, mesh, sync), donate,
                                  device=device, mesh=mesh, rules=rules)
