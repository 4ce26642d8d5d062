"""Algorithm: the top-level control loop (port of ray_tpu/rllib/algorithms/algorithm.py).

Capability parity: reference rllib/algorithms/algorithm.py — train() -> training_step();
checkpointing via get/set_state (Algorithm -> LearnerGroup -> Learner -> RLModule
params). The JAX package's Algorithm subclasses the Trainable of
ray_tpu/tune/trainable.py; the port keeps its own copy of the few lines of
it that Algorithm uses (``Trainable`` below).

The learner runs on the config's device (the card unless it asks for the
CPU); the env runners step on the host, in the calling process. An offline
algorithm (no env) takes its spaces from the config and builds no runners.
The decoupled rollout plane (ROADMAP A9c) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.device import resolve_device

from ..core.learner import Learner
from ..core.learner_group import LearnerGroup
from ..core.rl_module import RLModuleSpec
from ..env.env_runner_group import EnvRunnerGroup
from ..utils.metrics_logger import MetricsLogger
from .algorithm_config import AlgorithmConfig

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """The class API of ray_tpu/tune/trainable.py that Algorithm uses:
    setup/step/save_checkpoint/load_checkpoint, and train/save/restore/stop."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self._iteration = 0
        self.setup(self.config)

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        return None

    def load_checkpoint(self, checkpoint: Any) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def train(self) -> Dict[str, Any]:
        result = self.step() or {}
        self._iteration += 1
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault(DONE, False)
        return result

    def save(self) -> Any:
        return {"state": self.save_checkpoint(), "iteration": self._iteration}

    def restore(self, payload: Any) -> None:
        self._iteration = payload.get("iteration", 0)
        self.load_checkpoint(payload.get("state"))

    def stop(self) -> None:
        self.cleanup()


class Algorithm(Trainable):
    learner_class: type = Learner

    def __init__(self, config):
        if isinstance(config, dict):  # Tune passes plain dicts
            base = self.get_default_config()
            for k, v in config.items():
                setattr(base, k, v)
            config = base
        self._algo_config = config
        super().__init__({})

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return AlgorithmConfig(cls)

    # -- Trainable hooks -------------------------------------------------------
    def setup(self, _config: Dict[str, Any]) -> None:
        cfg = self._algo_config
        resolve_device(cfg.device)  # before any env is built: no CUDA, no algorithm
        self.metrics = MetricsLogger()
        if cfg.env is not None:
            probe = cfg.env_maker()()
            obs_space, act_space = probe.observation_space, probe.action_space
            probe.close()
        else:
            # offline mode (reference offline algos): spaces come from the config
            obs_space, act_space = cfg.observation_space, cfg.action_space
            if obs_space is None or act_space is None:
                raise ValueError(
                    "offline algorithms need .environment(observation_space=..., action_space=...)"
                )
        self.module_spec = RLModuleSpec(
            module_class=cfg.rl_module_class,
            observation_space=obs_space,
            action_space=act_space,
            model_config=cfg.model_config,
        )
        self.learner_group = LearnerGroup(cfg, self.module_spec, self.learner_class)
        self.env_runner_group = EnvRunnerGroup(cfg) if cfg.env is not None else None
        # host-side module copy for connectors (GAE bootstrap values)
        self._module = self.module_spec.build()
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def step(self) -> Dict[str, Any]:
        return self.training_step()

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        return {"learner": self.learner_group.get_state(), "config": None}

    def load_checkpoint(self, state: Any) -> None:
        self.learner_group.set_state(state["learner"])
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def cleanup(self) -> None:
        try:
            if self.env_runner_group is not None:
                self.env_runner_group.stop()
        finally:
            self.learner_group.shutdown()

    stop = cleanup  # reference Algorithm.stop()

    # -- convenience -----------------------------------------------------------
    def get_weights(self):
        return self.learner_group.get_weights()

    def evaluate(self, num_timesteps: int = 1000) -> Dict[str, Any]:
        if self.env_runner_group is None:
            return {"evaluation": {"episode_return_mean": None}}
        eps = self.env_runner_group.sample(num_timesteps, explore=False)
        rets = [float(e["rewards"].sum()) for e in eps if e["terminated"] or e["truncated"]]
        return {"evaluation": {"episode_return_mean": float(np.mean(rets)) if rets else None}}
