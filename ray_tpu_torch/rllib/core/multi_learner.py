"""MultiAgentLearner: one sub-learner per policy id (port of
ray_tpu/rllib/core/multi_learner.py).

Capability parity: reference rllib/core/rl_module/multi_rl_module.py +
learner.py's per-module loss loop — each policy id gets an independent
sub-learner (its own params, optimizer and update), each on the config's
device; updates run module by module in sorted order, as in the JAX package.
The state is keyed by module, and each module's state is its sub-learner's,
which takes either package's form.
"""
from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.device import resolve_device

from .learner import Learner


class MultiAgentLearner(Learner):
    def __init__(self, config: "AlgorithmConfig", module_specs: Dict[str, Any]):  # noqa: F821
        self.config = config
        self.module_specs = module_specs
        self.device = resolve_device(getattr(config, "device", None))
        base = config.base_learner_class
        self._subs: Dict[str, Learner] = {
            mid: base(config, spec) for mid, spec in sorted(module_specs.items())
        }

    def build(self) -> None:
        for sub in self._subs.values():
            sub.build()

    def update(self, batches: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        return {mid: self._subs[mid].update(b) for mid, b in sorted(batches.items())}

    def get_weights(self):
        return {mid: sub.get_weights() for mid, sub in self._subs.items()}

    def get_state(self) -> Dict[str, Any]:
        return {mid: sub.get_state() for mid, sub in self._subs.items()}

    def set_state(self, state: Dict[str, Any]) -> None:
        for mid, s in state.items():
            if mid in self._subs:
                self._subs[mid].set_state(s)
