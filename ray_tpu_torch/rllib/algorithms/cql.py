"""CQL: conservative Q-learning for offline continuous control (port of
ray_tpu/rllib/algorithms/cql.py).

Capability parity: reference rllib/algorithms/cql/ — SAC's twin-Q losses plus the
CQL(H) conservative regularizer (importance-sampled logsumexp of Q over random +
policy actions minus Q on dataset actions, Kumar et al. 2020) and `bc_iters`
warm-start (actor imitates the dataset before switching to the Q-maximizing loss).
Offline input via OfflineData; no env runners, no replay buffer.

The JAX loss computes both actor terms and picks one with ``jnp.where``; the
gradient of the branch not taken is zero there, so here only the branch taken
is computed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.distributions import squashed_logp_from_u_torch
from ..offline import OfflineData
from .algorithm import Algorithm
from .sac import SAC, SACConfig, SACLearner, sg_tree


class CQLConfig(SACConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or CQL)
        self.min_q_weight: float = 5.0
        self.num_cql_actions: int = 4  # sampled actions per logsumexp branch
        self.bc_iters: int = 200
        self.num_updates_per_iteration = 64

    def training(self, *, min_q_weight=None, num_cql_actions=None, bc_iters=None, **kwargs):
        for k, v in dict(min_q_weight=min_q_weight, num_cql_actions=num_cql_actions,
                         bc_iters=bc_iters).items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


class CQLLearner(SACLearner):
    def build(self) -> None:
        super().build()
        self._num_updates = 0

    def draw_noise(self, b: int) -> Dict[str, torch.Tensor]:
        """Every random number of one update: [B, A] normals for the next
        action and the actor, [N*B, A] normals for the policy's actions at
        s and s', and [N, B, A] uniform actions in [low, high]."""
        n, a = self.config.num_cql_actions, self.module.act_dim
        low, high = self.module.bounds_torch(self.device)
        uniform = torch.rand((n, b, a), generator=self.generator, device=self.device)
        return {"next": self._normal(b, a), "random_actions": low + (high - low) * uniform,
                "current": self._normal(n * b, a), "next_state": self._normal(n * b, a),
                "actor": self._normal(b, a)}

    def compute_losses(self, params, batch, noise, use_bc):
        cfg = self.config
        module = self.module
        target_ent = self._target_entropy
        alpha = torch.exp(params["log_alpha"])
        obs, next_obs = batch["obs"], batch["next_obs"]
        B = obs.shape[0]
        N = cfg.num_cql_actions
        A = module.act_dim

        def q_many(which, actions_n):
            """Q over N actions per state: actions_n [N,B,A] -> [N,B]."""
            obs_rep = obs[None].expand((N,) + obs.shape).reshape(N * B, -1)
            return module.q_torch(params, which, obs_rep, actions_n.reshape(N * B, -1)).reshape(N, B)

        # --- standard SAC critic targets ---
        next_a, next_logp = module.sample_action_torch(sg_tree(params), next_obs, noise["next"])
        tq1 = module.q_torch(self.target_params, "q1", next_obs, next_a)
        tq2 = module.q_torch(self.target_params, "q2", next_obs, next_a)
        target_v = torch.minimum(tq1, tq2) - alpha.detach() * next_logp
        target = (batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * target_v).detach()
        q1 = module.q_torch(params, "q1", obs, batch["actions"])
        q2 = module.q_torch(params, "q2", obs, batch["actions"])
        bellman = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

        # --- CQL(H) conservative regularizer ---
        low, high = module.bounds_torch(obs.device)
        rand_a = noise["random_actions"]
        rand_logp = -torch.sum(torch.log(high - low))  # uniform density over the box

        def pi_actions(eps, states):
            rep = states[None].expand((N,) + states.shape).reshape(N * B, -1)
            a, lp = module.sample_action_torch(sg_tree(params), rep, eps)
            return a.reshape(N, B, A), lp.reshape(N, B)

        cur_a, cur_lp = pi_actions(noise["current"], obs)
        nxt_a, nxt_lp = pi_actions(noise["next_state"], next_obs)

        def conservative(which, q_data):
            q_rand = q_many(which, rand_a) - rand_logp
            q_cur = q_many(which, cur_a) - cur_lp.detach()
            q_nxt = q_many(which, nxt_a) - nxt_lp.detach()
            stacked = torch.cat([q_rand, q_cur, q_nxt], dim=0)  # [3N, B]
            return torch.mean(torch.logsumexp(stacked, dim=0) - q_data)

        cql_term = conservative("q1", q1) + conservative("q2", q2)
        critic_loss = bellman + cfg.min_q_weight * cql_term

        # --- actor: BC warm-start, then SAC objective ---
        a_new, logp = module.sample_action_torch(params, obs, noise["actor"])
        if use_bc:
            # BC: maximize logp of the dataset action under the squashed gaussian
            mu, log_std = module.pi_torch(params, obs)
            # invert the squash to score dataset actions (clip to the open interval)
            t = torch.clamp((batch["actions"] - low) / (high - low) * 2.0 - 1.0, -0.999, 0.999)
            data_logp = squashed_logp_from_u_torch(torch.atanh(t), t, mu, log_std, low, high)
            actor_loss = torch.mean(alpha.detach() * logp - data_logp)
        else:
            frozen = {**params, "q1": sg_tree(params["q1"]), "q2": sg_tree(params["q2"])}
            q_pi = torch.minimum(module.q_torch(frozen, "q1", obs, a_new),
                                 module.q_torch(frozen, "q2", obs, a_new))
            actor_loss = torch.mean(alpha.detach() * logp - q_pi)

        alpha_loss = -torch.mean(params["log_alpha"] * (logp + target_ent).detach())
        total = critic_loss + actor_loss + alpha_loss
        aux = {"critic_loss": critic_loss, "actor_loss": actor_loss,
               "cql_loss": cql_term, "alpha": alpha, "mean_q": torch.mean(q1)}
        return total, aux

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        noise = self.draw_noise(len(batch["obs"]))
        use_bc = self._num_updates < self.config.bc_iters
        loss, aux = self._update_step(batch, noise, use_bc)
        self._sync_targets(self.config.tau)
        self._num_updates += 1
        return self._read_back(loss, aux)

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["num_updates"] = self._num_updates
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        # restore the update counter so a resumed run doesn't redo BC warm-start
        self._num_updates = int(state.get("num_updates", self.config.bc_iters))


class CQL(SAC):
    learner_class = CQLLearner

    @classmethod
    def get_default_config(cls) -> CQLConfig:
        return CQLConfig(cls)

    def setup(self, _config) -> None:
        cfg = self._algo_config
        # skip SAC.setup: offline CQL has no replay buffer or env-step accounting
        Algorithm.setup(self, _config)
        self._rng = np.random.default_rng(cfg.seed or 0)
        self._env_steps = 0  # SAC.save_checkpoint expects it
        self.offline_data = OfflineData(cfg)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        for _ in range(cfg.num_updates_per_iteration):
            batch = self.offline_data.sample(cfg.train_batch_size, self._rng)
            for lm in self.learner_group.update(batch):
                self.metrics.log_dict(lm)
        return self.metrics.reduce()
