"""DQN: deep Q-learning with target network, double-Q, and replay (port of
ray_tpu/rllib/algorithms/dqn.py).

Capability parity: reference rllib/algorithms/dqn/ (dqn.py training_step —
sample → store → replay-train → target sync; dqn_rainbow_learner's huber TD loss
with double-Q). The learner takes one step on each replayed batch on its
device; the target network is a second tree of device tensors, hard-copied
every ``target_network_update_freq`` updates (polyak at ``tau`` < 1). The
replay buffer and the env runners stay on the host.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import Learner
from ..core.rl_module import DQNModule, params_from_numpy, to_numpy
from ..utils.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or DQN)
        self.rl_module_class = DQNModule
        # off-policy knobs (reference DQNConfig.training surface)
        self.replay_buffer_capacity: int = 50_000
        self.prioritized_replay: bool = False
        self.num_steps_sampled_before_learning_starts: int = 1000
        self.target_network_update_freq: int = 200  # learner updates between hard syncs
        self.tau: float = 1.0  # 1.0 = hard sync; <1 = polyak every update
        self.double_q: bool = True
        self.n_step: int = 1
        self.epsilon: tuple = (1.0, 0.05)  # (initial, final)
        self.epsilon_timesteps: int = 10_000
        self.num_updates_per_iteration: int = 16
        self.sample_timesteps_per_iteration: int = 512
        # sensible off-policy defaults (the base defaults are PPO-shaped)
        self.train_batch_size = 64
        self.lr = 1e-3
        self.num_epochs = 1

    def training(self, *, replay_buffer_capacity=None, prioritized_replay=None,
                 num_steps_sampled_before_learning_starts=None,
                 target_network_update_freq=None, tau=None, double_q=None,
                 n_step=None, epsilon=None, epsilon_timesteps=None,
                 num_updates_per_iteration=None,
                 sample_timesteps_per_iteration=None, **kwargs) -> "DQNConfig":
        for k, v in dict(
            replay_buffer_capacity=replay_buffer_capacity,
            prioritized_replay=prioritized_replay,
            num_steps_sampled_before_learning_starts=num_steps_sampled_before_learning_starts,
            target_network_update_freq=target_network_update_freq, tau=tau,
            double_q=double_q, n_step=n_step, epsilon=epsilon,
            epsilon_timesteps=epsilon_timesteps,
            num_updates_per_iteration=num_updates_per_iteration,
            sample_timesteps_per_iteration=sample_timesteps_per_iteration,
        ).items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


class DQNLearner(Learner):
    """Huber TD loss with target network + optional double-Q."""

    def build(self) -> None:
        super().build()
        self.target_params = params_from_numpy(to_numpy(self.params), self.device)
        self._updates_since_sync = 0

    def compute_losses(self, params, batch):
        cfg = self.config
        module = self.module
        q = module.q_values_torch(params, batch["obs"])  # [B, A]
        qa = q.gather(1, batch["actions"].long()[:, None])[:, 0]
        q_next_t = module.q_values_torch(self.target_params, batch["next_obs"])
        if cfg.double_q:
            # action selection by the online net, evaluation by the target net
            # (argmax takes the first of tied maxima, as jnp.argmax does)
            next_a = torch.argmax(module.q_values_torch(params, batch["next_obs"]), dim=1)
            next_v = q_next_t.gather(1, next_a[:, None])[:, 0]
        else:
            next_v = q_next_t.max(dim=1).values
        # n-step: rewards are already the discounted n-step sum; bootstrap γ^n
        target = (batch["rewards"]
                  + (cfg.gamma ** cfg.n_step) * (1.0 - batch["dones"]) * next_v)
        td = qa - target.detach()
        huber = torch.where(torch.abs(td) < 1.0, 0.5 * td * td, torch.abs(td) - 0.5)
        weights = batch.get("weights")
        loss = torch.mean(huber * weights) if weights is not None else torch.mean(huber)
        aux = {
            "mean_q": torch.mean(qa),
            "mean_target": torch.mean(target),
            "mean_td_error": torch.mean(torch.abs(td)),
            "td_errors": td,  # per-sample, for priority updates
        }
        return loss, aux

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        loss, aux = self._update_step({k: v for k, v in batch.items() if k != "batch_indexes"})
        # target sync: polyak each step (tau<1) or hard copy every N updates
        self._updates_since_sync += 1
        cfg = self.config
        if cfg.tau < 1.0:
            self._sync_targets(cfg.tau)
        elif self._updates_since_sync >= cfg.target_network_update_freq:
            self._sync_targets(1.0)
            self._updates_since_sync = 0
        td = aux.pop("td_errors")
        # ONE read-back per update: the loss, the metrics and the td errors
        host = torch.cat([torch.stack([loss, *aux.values()]), td]).cpu().numpy()
        self.metrics = {"total_loss": float(host[0]),
                        **{k: float(v) for k, v in zip(aux, host[1:len(aux) + 1])}}
        # for prioritized replay: td errors with the batch's own indexes
        self.metrics["_td_errors"] = host[len(aux) + 1:]
        if "batch_indexes" in batch:
            self.metrics["_batch_indexes"] = np.asarray(batch["batch_indexes"])
        return self.metrics


class DQN(Algorithm):
    learner_class = DQNLearner

    @classmethod
    def get_default_config(cls) -> DQNConfig:
        return DQNConfig(cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self._algo_config
        buf_cls = PrioritizedReplayBuffer if cfg.prioritized_replay else ReplayBuffer
        self.buffer = buf_cls(cfg.replay_buffer_capacity, n_step=cfg.n_step,
                              gamma=cfg.gamma)
        self._rng = np.random.default_rng(cfg.seed or 0)
        self._env_steps = 0
        self._sync_epsilon()

    def _epsilon(self) -> float:
        e0, e1 = self._algo_config.epsilon
        frac = min(1.0, self._env_steps / max(1, self._algo_config.epsilon_timesteps))
        return float(e0 + (e1 - e0) * frac)

    def _sync_epsilon(self) -> None:
        w = dict(self.learner_group.get_weights())
        w["epsilon"] = np.float32(self._epsilon())
        self.env_runner_group.sync_weights(w)

    def save_checkpoint(self) -> Any:
        state = super().save_checkpoint()
        state["env_steps"] = self._env_steps  # epsilon schedule position
        return state

    def load_checkpoint(self, state: Any) -> None:
        super().load_checkpoint(state)
        self._env_steps = int(state.get("env_steps", 0))
        self._sync_epsilon()  # undo the raw-weight sync's stale epsilon leaf

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        # 1. sample with the current epsilon, store transitions (dqn.py sample phase)
        episodes = self.env_runner_group.sample(cfg.sample_timesteps_per_iteration)
        added = self.buffer.add_episodes(episodes)
        self._env_steps += added
        for m in self.env_runner_group.get_metrics():
            self.metrics.log_dict({k: v for k, v in m.items() if v is not None}, window=20)

        # 2. replay-train once warm (dqn.py update phase)
        if len(self.buffer) >= cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.num_updates_per_iteration):
                batch = self.buffer.sample(cfg.train_batch_size, self._rng)
                for lm in self.learner_group.update(batch):
                    td = lm.pop("_td_errors", None)
                    idx = lm.pop("_batch_indexes", None)
                    if td is not None and idx is not None:
                        self.buffer.update_priorities(idx, td)
                    self.metrics.log_dict(lm)

        # 3. decayed epsilon + fresh weights to the runners
        self._sync_epsilon()
        result = self.metrics.reduce()
        result["num_env_steps_sampled_lifetime"] = self._env_steps
        result["epsilon"] = self._epsilon()
        return result
