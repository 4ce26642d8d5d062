"""EnvRunnerGroup: the set of rollout workers (port of
ray_tpu/rllib/env/env_runner_group.py).

The JAX package places each runner in an actor of its own runtime and samples
them in parallel. The port has no actor runtime, so the group holds
``num_env_runners`` runners in the calling process and steps runner 0, 1, …
in turn, merging their episodes in the order the JAX group merges its
results: the samples equal the JAX group's. Placing runners in actors
through a hosting runtime is ROADMAP A9b.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .env_runner import SingleAgentEnvRunner


class EnvRunnerGroup:
    def __init__(self, config: "AlgorithmConfig"):  # noqa: F821
        self.config = config
        self.n = max(1, config.num_env_runners)
        self.runners = [SingleAgentEnvRunner(config, i) for i in range(self.n)]

    def sample(self, num_timesteps_total: Optional[int] = None,
               explore: bool = True) -> List[Dict[str, np.ndarray]]:
        """Sample every runner in turn; returns the merged episode list."""
        per = None
        if num_timesteps_total:
            per = max(1, num_timesteps_total // self.n)
        episodes: List[Dict[str, np.ndarray]] = []
        for r in self.runners:
            episodes.extend(r.sample(per, explore))
        return episodes

    def sync_weights(self, weights) -> None:
        """Push inference weights (a numpy tree) to all runners."""
        for r in self.runners:
            r.set_weights(weights)

    def get_metrics(self) -> List[Dict[str, Any]]:
        return [r.get_metrics() for r in self.runners]

    def stop(self) -> None:
        for r in self.runners:
            r.stop()
