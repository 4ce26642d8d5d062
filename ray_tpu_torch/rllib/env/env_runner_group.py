"""EnvRunnerGroup: the set of rollout workers (port of
ray_tpu/rllib/env/env_runner_group.py).

The JAX package places each runner in an actor of its own runtime and samples
them in parallel. The port has no actor runtime, so the group holds
``num_env_runners`` runners in the calling process and steps runner 0, 1, …
in turn, merging their episodes in the order the JAX group merges its
results: the samples equal the JAX group's. ``runner_cls`` picks another
runner (the multi-agent runner, DreamerV3's recurrent one); a multi-agent
runner's ``module_id -> episodes`` dicts merge per module in runner order.
Placing runners in actors through a hosting runtime is ROADMAP A9b.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .env_runner import SingleAgentEnvRunner


class EnvRunnerGroup:
    def __init__(self, config: "AlgorithmConfig", runner_cls: type = None):  # noqa: F821
        runner_cls = runner_cls or SingleAgentEnvRunner
        self.config = config
        self.n = max(1, config.num_env_runners)
        self.runners = [runner_cls(config, i) for i in range(self.n)]

    def sample(self, num_timesteps_total: Optional[int] = None, explore: bool = True):
        """Sample every runner in turn; returns a merged episode list
        (single-agent) or a module_id -> episode-list dict (multi-agent runners)."""
        per = None
        if num_timesteps_total:
            per = max(1, num_timesteps_total // self.n)
        episodes: List[Dict[str, np.ndarray]] = []
        by_module: Dict[str, List] = {}
        saw_dict = False
        for r in self.runners:
            res = r.sample(per, explore)
            if isinstance(res, dict):
                saw_dict = True
                for mid, eps in res.items():
                    by_module.setdefault(mid, []).extend(eps)
            else:
                episodes.extend(res)
        return by_module if saw_dict else episodes

    def sync_weights(self, weights) -> None:
        """Push inference weights (a numpy tree) to all runners."""
        for r in self.runners:
            r.set_weights(weights)

    def get_metrics(self) -> List[Dict[str, Any]]:
        return [r.get_metrics() for r in self.runners]

    def stop(self) -> None:
        for r in self.runners:
            r.stop()
