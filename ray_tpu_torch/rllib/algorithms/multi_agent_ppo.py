"""MultiAgentPPO: independent PPO per policy module over a MultiAgentEnv (port
of ray_tpu/rllib/algorithms/multi_agent_ppo.py).

Capability parity: reference rllib's multi-agent new API stack (PPO +
MultiRLModule + MultiAgentEnvRunner + policy_mapping_fn). Each policy id gets
its own params and optimizer on the learner's device (MultiAgentLearner, the
card unless the config asks for the CPU); rollouts come back grouped by
module from runners that step on the host; GAE runs per module on the host
and the PPO update per module on the device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.device import resolve_device

from ..connectors import GeneralAdvantageEstimation
from ..core.learner_group import LearnerGroup
from ..core.multi_learner import MultiAgentLearner
from ..env.env_runner_group import EnvRunnerGroup
from ..env.multi_agent_env_runner import MultiAgentEnvRunner
from ..utils.metrics_logger import MetricsLogger
from .ppo import PPO, PPOConfig, PPOLearner


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or MultiAgentPPO)


class MultiAgentPPO(PPO):
    learner_class = MultiAgentLearner
    base_learner_class = PPOLearner

    @classmethod
    def get_default_config(cls) -> MultiAgentPPOConfig:
        return MultiAgentPPOConfig(cls)

    def setup(self, _config) -> None:
        cfg = self._algo_config
        resolve_device(cfg.device)  # before any env is built: no CUDA, no algorithm
        if not cfg.is_multi_agent:
            cfg.multi_agent(policies=["default_policy"])
        cfg.base_learner_class = type(self).base_learner_class
        self.metrics = MetricsLogger()
        probe = cfg.env_maker()()
        self.module_specs = cfg.resolved_policy_specs(probe)
        probe.close()
        self.env_runner_group = EnvRunnerGroup(cfg, runner_cls=MultiAgentEnvRunner)
        self.learner_group = LearnerGroup(cfg, self.module_specs, self.learner_class)
        # host-side module copies for GAE bootstrap values
        self._modules = {mid: spec.build() for mid, spec in self.module_specs.items()}
        self._gae = GeneralAdvantageEstimation(cfg.gamma, cfg.lambda_)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        samples: Dict[str, list] = self.env_runner_group.sample(cfg.train_batch_size)
        if not samples or not any(samples.values()):
            return self.metrics.reduce()
        for m in self.env_runner_group.get_metrics():
            self.metrics.log_dict({k: v for k, v in m.items() if v is not None}, window=20)
        params = self.learner_group.get_weights()
        batches = {
            mid: self._gae(eps, module=self._modules[mid], params=params[mid])
            for mid, eps in samples.items() if eps
        }
        learner_metrics = self.learner_group.update(batches)
        for lm in learner_metrics:
            for mid, m in lm.items():
                self.metrics.log_dict({f"{mid}/{k}": v for k, v in m.items()})
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self.metrics.reduce()
        result["num_env_steps_trained"] = int(sum(
            len(b["obs"]) for b in batches.values()))
        return result

    def evaluate(self, num_timesteps: int = 1000) -> Dict[str, Any]:
        self.env_runner_group.sample(num_timesteps, explore=False)
        rets = [m.get("episode_return_mean") for m in self.env_runner_group.get_metrics()
                if m.get("episode_return_mean") is not None]
        return {"evaluation": {"episode_return_mean": float(np.mean(rets)) if rets else None}}
