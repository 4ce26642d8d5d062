"""LearnerGroup (port of ray_tpu/rllib/core/learner_group.py).

The JAX package places each learner in an actor of its own runtime and syncs
gradients across them with a collective allreduce. The port has no actor
runtime: the group holds one ``Learner`` in the calling process, on the
config's device. More than one learner, with its gradient sync, and placing
the learner through a hosting runtime are ROADMAP A9b; the decoupled rollout
plane's methods are A9c.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .learner import Learner
from .rl_module import RLModuleSpec


class LearnerGroup:
    def __init__(
        self,
        config: "AlgorithmConfig",  # noqa: F821
        module_spec: RLModuleSpec,
        learner_class: type = Learner,
    ):
        if config.num_learners > 1:
            raise NotImplementedError(
                "num_learners > 1 (multi-learner grad sync) is not ported yet (ROADMAP A9b)")
        self.config = config
        self.learners = [learner_class(config, module_spec)]
        self.learners[0].build()

    def update(self, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Update the learner on the batch's numpy columns; one metrics dict
        per learner, as the JAX group returns them."""
        if batch and all(isinstance(v, dict) for v in batch.values()):
            raise NotImplementedError(
                "a module_id -> batch dict (multi-agent) is not ported yet (ROADMAP A9g)")
        return [self.learners[0].update(
            {k: v for k, v in batch.items() if isinstance(v, np.ndarray)})]

    def update_from_blocks(self, handles: List[Any]) -> List[Dict[str, Any]]:
        raise NotImplementedError(
            "the decoupled rollout plane is not ported yet (ROADMAP A9c)")

    def get_weights(self):
        return self.learners[0].get_weights()

    def get_state(self) -> Dict[str, Any]:
        return self.learners[0].get_state()

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learners[0].set_state(state)

    def shutdown(self) -> None:
        """Nothing to stop: the learner lives in the calling process."""
