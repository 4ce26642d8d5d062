"""SAC: soft actor-critic for continuous control (port of
ray_tpu/rllib/algorithms/sac.py).

Capability parity: reference rllib/algorithms/sac/ (sac.py + sac_torch_learner's
twin-Q critic loss, reparameterized actor loss, auto-tuned temperature). One
update computes all three losses on the learner's device; per-branch
stop-gradients on parameter leaves (``.detach()`` where the JAX loss has
``stop_gradient``, not on activations) keep each loss updating only its own
network while the reparameterized action gradient still flows through the
critics into the policy.

The JAX loss draws its noise from ``jax.random`` inside the update; here it
comes in as tensors (``draw_noise``, from the learner's ``torch.Generator``
on its device, seeded from ``config.seed``), so a caller may hand it any draws.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.train.optim import adamw_init

from ..core.learner import Learner
from ..core.rl_module import SACModule, params_from_numpy, to_numpy, tree_map
from ..utils.replay_buffer import ReplayBuffer
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


def sg_tree(tree):
    """jax.tree_util.tree_map(stop_gradient, tree)."""
    return tree_map(lambda t: t.detach(), tree)


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or SAC)
        self.rl_module_class = SACModule
        self.replay_buffer_capacity: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 500
        self.tau: float = 0.005  # polyak target update
        self.n_step: int = 1
        self.initial_alpha: float = 1.0
        self.target_entropy: str | float = "auto"  # auto = -act_dim
        # SAC wants ~1 gradient update per env step (reference training_intensity)
        self.num_updates_per_iteration: int = 256
        self.sample_timesteps_per_iteration: int = 256
        self.train_batch_size = 256
        self.lr = 3e-4
        self.num_epochs = 1

    def training(self, *, replay_buffer_capacity=None,
                 num_steps_sampled_before_learning_starts=None, tau=None,
                 n_step=None, initial_alpha=None, target_entropy=None,
                 num_updates_per_iteration=None,
                 sample_timesteps_per_iteration=None, **kwargs) -> "SACConfig":
        for k, v in dict(
            replay_buffer_capacity=replay_buffer_capacity,
            num_steps_sampled_before_learning_starts=num_steps_sampled_before_learning_starts,
            tau=tau, n_step=n_step, initial_alpha=initial_alpha,
            target_entropy=target_entropy,
            num_updates_per_iteration=num_updates_per_iteration,
            sample_timesteps_per_iteration=sample_timesteps_per_iteration,
        ).items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


class SACLearner(Learner):
    def build(self) -> None:
        super().build()
        with torch.no_grad():
            self.params["log_alpha"].fill_(float(np.log(self.config.initial_alpha)))
        self.opt_state = adamw_init(self._leaves)  # re-init with alpha set
        self.target_params = params_from_numpy(
            to_numpy({"q1": self.params["q1"], "q2": self.params["q2"]}), self.device)
        te = self.config.target_entropy
        self._target_entropy = float(-self.module.act_dim if te == "auto" else te)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed or 0)

    def _normal(self, *shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def draw_noise(self, b: int) -> Dict[str, torch.Tensor]:
        """Every random number of one update, [B, A] standard normals: the
        next action's (critic target) and the actor's."""
        a = self.module.act_dim
        return {"next": self._normal(b, a), "actor": self._normal(b, a)}

    def compute_losses(self, params, batch, noise):
        cfg = self.config
        module = self.module
        target_ent = self._target_entropy
        alpha = torch.exp(params["log_alpha"])

        # critic loss: targets from target nets + current policy at s'
        next_a, next_logp = module.sample_action_torch(sg_tree(params), batch["next_obs"],
                                                       noise["next"])
        tq1 = module.q_torch(self.target_params, "q1", batch["next_obs"], next_a)
        tq2 = module.q_torch(self.target_params, "q2", batch["next_obs"], next_a)
        target_v = torch.minimum(tq1, tq2) - alpha.detach() * next_logp
        target = (batch["rewards"]
                  + (cfg.gamma ** cfg.n_step) * (1.0 - batch["dones"]) * target_v).detach()
        q1 = module.q_torch(params, "q1", batch["obs"], batch["actions"])
        q2 = module.q_torch(params, "q2", batch["obs"], batch["actions"])
        critic_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

        # actor loss: reparameterized action through FROZEN critics
        frozen = {**params, "q1": sg_tree(params["q1"]), "q2": sg_tree(params["q2"])}
        a_new, logp = module.sample_action_torch(params, batch["obs"], noise["actor"])
        q_pi = torch.minimum(module.q_torch(frozen, "q1", batch["obs"], a_new),
                             module.q_torch(frozen, "q2", batch["obs"], a_new))
        actor_loss = torch.mean(alpha.detach() * logp - q_pi)

        # temperature: drive policy entropy toward the target
        alpha_loss = -torch.mean(params["log_alpha"] * (logp + target_ent).detach())

        total = critic_loss + actor_loss + alpha_loss
        aux = {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "mean_q": torch.mean(q1),
            "mean_logp": torch.mean(logp),
        }
        return total, aux

    def _read_back(self, loss, aux) -> Dict[str, Any]:
        """ONE read-back per update: the loss and the metrics."""
        host = torch.stack([loss, *aux.values()]).cpu().numpy()
        self.metrics = {"total_loss": float(host[0]),
                        **{k: float(v) for k, v in zip(aux, host[1:])}}
        return self.metrics

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        noise = self.draw_noise(len(batch["obs"]))
        loss, aux = self._update_step(batch, noise)
        self._sync_targets(self.config.tau)  # polyak target update
        return self._read_back(loss, aux)


class SAC(Algorithm):
    learner_class = SACLearner

    @classmethod
    def get_default_config(cls) -> SACConfig:
        return SACConfig(cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self._algo_config
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, n_step=cfg.n_step,
                                   gamma=cfg.gamma)
        self._rng = np.random.default_rng(cfg.seed or 0)
        self._env_steps = 0

    def save_checkpoint(self) -> Any:
        state = super().save_checkpoint()
        state["env_steps"] = self._env_steps
        return state

    def load_checkpoint(self, state: Any) -> None:
        super().load_checkpoint(state)
        self._env_steps = int(state.get("env_steps", 0))

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        episodes = self.env_runner_group.sample(cfg.sample_timesteps_per_iteration)
        self._env_steps += self.buffer.add_episodes(episodes)
        for m in self.env_runner_group.get_metrics():
            self.metrics.log_dict({k: v for k, v in m.items() if v is not None}, window=20)
        if len(self.buffer) >= cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.num_updates_per_iteration):
                batch = self.buffer.sample(cfg.train_batch_size, self._rng)
                for lm in self.learner_group.update(batch):
                    self.metrics.log_dict(lm)
            self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self.metrics.reduce()
        result["num_env_steps_sampled_lifetime"] = self._env_steps
        return result
