"""AlgorithmConfig: fluent builder (port of ray_tpu/rllib/algorithms/algorithm_config.py).

Capability parity: reference rllib/algorithms/algorithm_config.py — .environment()/
.training()/.env_runners()/.learners()/.offline_data() chaining, build_algo().
The knobs the ported algorithms use are carried, plus ``device``: the
learner's device, the card unless "cpu" is asked for
(``ray_tpu_torch.device.resolve_device``, no fallback).

Not ported yet, each raising NotImplementedError naming its ROADMAP item:
``num_learners > 1`` (A9b), ``decoupled_rollout(enabled=True)`` (A9c),
``multi_agent`` (A9g).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

from ..env.env_runner import import_gymnasium


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Any = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners: int = 2
        self.num_envs_per_env_runner: int = 4
        self.rollout_fragment_length: int = 64
        # training
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 2048
        self.minibatch_size: int = 256
        self.num_epochs: int = 8
        self.grad_clip: Optional[float] = None
        # learners
        self.num_learners: int = 1
        self.device: Any = None  # None = the card
        # module
        self.model_config: Dict[str, Any] = {}
        self.rl_module_class: Optional[type] = None
        # offline (reference offline_data.py)
        self.input_: Any = None  # newline-JSON / parquet path(s)
        self.input_dataset: Any = None  # any object with take_all() -> row dicts
        self.observation_space: Any = None  # offline mode: spaces given, no env probe
        self.action_space: Any = None
        # misc
        self.seed: Optional[int] = 0

    # -- fluent sections (reference algorithm_config.py) -----------------------
    def environment(self, env=None, *, env_config: Optional[Dict] = None,
                    observation_space=None, action_space=None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        if observation_space is not None:
            self.observation_space = observation_space
        if action_space is not None:
            self.action_space = action_space
        return self

    def offline_data(self, *, input_=None, dataset=None, **_compat) -> "AlgorithmConfig":
        """Offline-RL input (reference AlgorithmConfig.offline_data / offline_data.py:30):
        `input_` newline-JSON (``.json``) or parquet path(s), or `dataset`,
        any object with ``take_all()``."""
        if input_ is not None:
            self.input_ = input_
        if dataset is not None:
            self.input_dataset = dataset
        return self

    def env_runners(
        self,
        *,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        **_compat,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(
        self,
        *,
        lr: Optional[float] = None,
        gamma: Optional[float] = None,
        train_batch_size: Optional[int] = None,
        minibatch_size: Optional[int] = None,
        num_epochs: Optional[int] = None,
        grad_clip: Optional[float] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        for k, v in dict(
            lr=lr, gamma=gamma, train_batch_size=train_batch_size,
            minibatch_size=minibatch_size, num_epochs=num_epochs, grad_clip=grad_clip,
        ).items():
            if v is not None:
                setattr(self, k, v)
        for k, v in kwargs.items():
            if hasattr(self, k) and v is not None:
                setattr(self, k, v)
        return self

    def learners(self, *, num_learners: Optional[int] = None, device: Any = None,
                 **_compat) -> "AlgorithmConfig":
        """`device`: the learner's device ("cuda", "cuda:1", "cpu"; None = the card)."""
        if num_learners is not None:
            if num_learners > 1:
                raise NotImplementedError(
                    "num_learners > 1 (multi-learner grad sync) is not ported yet "
                    "(ROADMAP A9b)")
            self.num_learners = num_learners
        if device is not None:
            self.device = device
        return self

    def rl_module(self, *, model_config: Optional[Dict] = None,
                  rl_module_class: Optional[type] = None) -> "AlgorithmConfig":
        if model_config is not None:
            self.model_config = dict(model_config)
        if rl_module_class is not None:
            self.rl_module_class = rl_module_class
        return self

    def multi_agent(self, **_kw) -> "AlgorithmConfig":
        raise NotImplementedError("multi-agent is not ported yet (ROADMAP A9g)")

    def decoupled_rollout(self, *, enabled: bool = True, **_kw) -> "AlgorithmConfig":
        if enabled:
            raise NotImplementedError(
                "the decoupled rollout plane is not ported yet (ROADMAP A9c)")
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def framework(self, *_a, **_k) -> "AlgorithmConfig":
        return self  # torch-only build

    # -- env factory -----------------------------------------------------------
    def env_maker(self) -> Callable[[], Any]:
        env, env_config = self.env, dict(self.env_config)
        if callable(env):
            return lambda: env(env_config)

        def make():
            gym = import_gymnasium(f"gym.make({env!r})")
            return gym.make(env, **env_config)

        return make

    def copy(self) -> "AlgorithmConfig":
        # share the (possibly large, materialized) offline dataset by reference
        ds, self.input_dataset = self.input_dataset, None
        try:
            new = copy.deepcopy(self)
        finally:
            self.input_dataset = ds
        new.input_dataset = ds
        return new

    def build_algo(self) -> "Algorithm":  # noqa: F821
        if self.algo_class is None:
            raise ValueError("no algo_class bound to this config")
        return self.algo_class(self.copy())

    build = build_algo  # older reference API name
