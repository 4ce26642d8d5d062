"""Learner: the gradient-update unit (port of ray_tpu/rllib/core/learner.py).

Capability parity: reference rllib/core/learner/learner.py:108 (compute_losses :893,
update :978) and torch/torch_learner.py:67. The parameters (f32 tensors), the
optimizer state and every minibatch live on the learner's device, the card
unless the config asks for the CPU.

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip)?, adam(lr))``,
which the JAX learner builds, written out with the port's ``train/optim.py``
(``clip_by_global_norm_`` and ``adamw_update_`` with no weight decay: optax's
adam is adamw without the decay term).

``update`` follows the JAX learner's default path: the batch goes to the
device once, every epoch's minibatches come from the same
``np.random.default_rng(0)`` permutation matrix, each minibatch is gathered
on the device (OBS cast to f32 per minibatch, so uint8 frames stay uint8
until gathered), and the metrics are read back once per update. The JAX
package runs that schedule as one jitted ``lax.scan``; here it is an eager
loop, one forward, backward and optimizer update per minibatch.

The off-policy learners (DQN, SAC, CQL) take one step on one whole batch
instead (``_update_step``) and keep target networks as device tensors
(``target_params``, synced by ``_sync_targets``); their state carries the
targets too.

Not ported yet: the multi-learner split path with its gradient allreduce
(ROADMAP A9b) and the decoupled rollout plane's block path (A9c).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.train.optim import AdamWState, adamw_init, adamw_update_, clip_by_global_norm_

from .rl_module import (Columns, RLModuleSpec, params_from_numpy, to_numpy, tree_leaves,
                        tree_unflatten)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _adam_state(opt_state) -> Any:
    """The ScaleByAdamState inside an optax chain's state (nested tuples):
    the one element with count, mu and nu."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


class Learner:
    """Owns one RLModule's params + optimizer; subclass defines the loss."""

    def __init__(self, config: "AlgorithmConfig", module_spec: RLModuleSpec):  # noqa: F821
        self.config = config
        self.module_spec = module_spec
        self.module = module_spec.build()
        self.device = resolve_device(getattr(config, "device", None))
        self.metrics: Dict[str, Any] = {}
        self.target_params = None  # the off-policy learners' target networks

    def build(self) -> None:
        self._set_params(self.module.init_params(seed=self.config.seed or 0))
        self.opt_state = adamw_init(self._leaves)

    def _set_params(self, tree) -> None:
        self.params = params_from_numpy(tree, self.device)
        self._leaves = tree_leaves(self.params)
        for p in self._leaves:
            p.requires_grad_(True)

    # -- to be provided by algo-specific learners ------------------------------
    def compute_losses(self, params, batch: Dict[str, Any]):
        """Return (total_loss, aux_metrics_dict) as 0-d tensors."""
        raise NotImplementedError

    @staticmethod
    def _cast_obs(batch):
        """Cast OBS (and a replayed batch's next_obs) to f32 at the minibatch
        level: a uint8 frame batch stays uint8 on the device until a
        minibatch is gathered from it."""
        batch = dict(batch)
        for k in (Columns.OBS, "next_obs"):
            if k in batch:
                batch[k] = batch[k].float()
        return batch

    def _upload(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Numpy columns to the device, once. f64 columns (DiagGaussian's
        sampled actions, offline rows' float lists) narrow to f32, as
        jax.device_put narrows them with 64-bit mode off."""
        return {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v)
                .to(self.device) for k, v in arrays.items()}

    def _step(self, mbatch: Dict[str, torch.Tensor], *args):
        """One minibatch: loss, gradients, optax's clip and adam in place.
        `args` go to compute_losses after the batch (SAC's noise)."""
        loss, aux, grads = self._grads(mbatch, *args)
        self._apply_grads(grads)
        return loss, aux

    def _grads(self, mbatch: Dict[str, torch.Tensor], *args):
        """The loss, its aux metrics (detached) and one gradient per leaf."""
        with torch.enable_grad():
            loss, aux = self.compute_losses(self.params, self._cast_obs(mbatch), *args)
            # a leaf the loss never reads (DQN's epsilon) gets a zero
            # gradient, as jax.grad gives it, and adam leaves it alone
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
                self._leaves, torch.autograd.grad(loss, self._leaves, allow_unused=True))]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def _apply_grads(self, grads: List[torch.Tensor]) -> None:
        """optax's clip and adam in place (the grads may be clipped in place)."""
        if self.config.grad_clip:
            clip_by_global_norm_(grads, self.config.grad_clip)
        self.opt_state = adamw_update_(
            grads, self.opt_state, self._leaves, learning_rate=lambda _: self.config.lr,
            b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS, weight_decay=0.0)

    # -- update ---------------------------------------------------------------
    def update(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One pass of minibatch SGD epochs over the batch (learner.py:_update)."""
        n = len(batch[Columns.OBS])
        arrays = {k: v for k, v in batch.items()
                  if isinstance(v, np.ndarray) and len(v) == n}
        return self._minibatch_sgd(arrays, n)

    def _minibatch_sgd(self, arrays: Dict[str, Any], n: int) -> Dict[str, Any]:
        mb = min(self.config.minibatch_size or n, n)
        rng = np.random.default_rng(0)
        # full minibatches only, every epoch's permutation stacked into one
        # [steps, mb] matrix, as the JAX learner builds it
        idx = np.stack([
            rng.permutation(n)[: (n // mb) * mb].reshape(-1, mb)
            for _ in range(self.config.num_epochs)]).reshape(-1, mb)
        on_dev = self._upload(arrays)
        idx_dev = torch.from_numpy(idx).to(self.device)
        losses: List[torch.Tensor] = []
        aux: Dict[str, torch.Tensor] = {}
        for ix in idx_dev:
            loss, aux = self._step({k: v[ix] for k, v in on_dev.items()})
            losses.append(loss)
        # ONE host sync for the whole update, after every minibatch ran
        host = torch.stack([*losses, *aux.values()]).cpu().numpy()
        self.metrics = {
            "total_loss": float(np.mean(host[: len(losses)])),
            **{k: float(v) for k, v in zip(aux, host[len(losses):])},
            "minibatch_steps": int(idx.shape[0]),
        }
        return self.metrics

    def _update_step(self, batch: Dict[str, np.ndarray], *args):
        """One step on one whole batch, uploaded once, with no minibatch loop
        (the off-policy learners' update); returns the loss and the aux
        metrics, still on the device."""
        return self._step(self._upload(batch), *args)

    def _sync_targets(self, tau: float) -> None:
        """The target networks from the parameters of the same names, in one
        foreach pass on the device: a hard copy at tau 1, else polyak,
        t = (1 - tau) t + tau p."""
        targets = tree_leaves(self.target_params)
        sources = tree_leaves({k: self.params[k] for k in self.target_params})
        with torch.no_grad():
            if tau >= 1.0:
                torch._foreach_copy_(targets, sources)
            else:
                torch._foreach_mul_(targets, 1.0 - tau)
                torch._foreach_add_(targets, sources, alpha=tau)

    def update_from_blocks(self, handles: List[Any]) -> Dict[str, Any]:
        raise NotImplementedError(
            "the decoupled rollout plane's block update is not ported yet (ROADMAP A9c)")

    # -- state ----------------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        """Numpy trees: params, and the optimizer's count, mu and nu (the
        leaves of optax's ScaleByAdamState; the chain's other states are
        empty); and the target networks where the learner has them."""
        state = {"params": to_numpy(self.params),
                 "opt_state": {"count": np.int32(self.opt_state.count),
                               "mu": to_numpy(tree_unflatten(self.params, self.opt_state.mu)),
                               "nu": to_numpy(tree_unflatten(self.params, self.opt_state.nu))}}
        if self.target_params is not None:
            state["target_params"] = to_numpy(self.target_params)
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        """Takes get_state's form, or the JAX learner's (its optax state as
        numpy or jax arrays). A state without opt_state keeps the optimizer's,
        one without target_params the targets."""
        self._set_params(state["params"])
        if state.get("target_params") is not None:
            self.target_params = params_from_numpy(state["target_params"], self.device)
        opt = state.get("opt_state")
        if opt is None:
            return
        adam = opt if isinstance(opt, dict) else _adam_state(opt)
        if adam is None:
            raise ValueError("opt_state holds no adam count, mu and nu")
        if not isinstance(adam, dict):
            adam = adam._asdict()
        self.opt_state = AdamWState(
            int(np.asarray(adam["count"])),
            tree_leaves(params_from_numpy(adam["mu"], self.device)),
            tree_leaves(params_from_numpy(adam["nu"], self.device)))

    def get_weights(self):
        return to_numpy(self.params)

