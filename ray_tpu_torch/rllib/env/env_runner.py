"""SingleAgentEnvRunner: the rollout worker (port of ray_tpu/rllib/env/env_runner.py).

Capability parity: reference rllib/env/single_agent_env_runner.py:68 (sample at :147) —
vector env stepping, exploration via the module's action distribution, episode
chunking on rollout_fragment_length, weight sync via set_state. It runs on the
host in numpy, as in the JAX package: the module's ``apply_np`` picks the actions.

An env class with a ``make_vec(num_envs, config)`` classmethod is stepped as
its own vector env; any other env goes through gymnasium's ``SyncVectorEnv``,
which is the one place here that imports gymnasium.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.rl_module import Columns, RLModuleSpec
from .episode import SingleAgentEpisode


def import_gymnasium(why: str):
    """gymnasium, imported only where it is needed; without it, an error
    that says what needed it."""
    try:
        import gymnasium
    except ImportError as e:
        raise ImportError(
            f"{why} needs gymnasium, which is not installed; pass an env class "
            "(with a make_vec classmethod to skip SyncVectorEnv) instead") from e
    return gymnasium


class SingleAgentEnvRunner:
    def __init__(self, config: "AlgorithmConfig", worker_index: int = 0):  # noqa: F821
        self.config = config
        self.worker_index = worker_index
        self.num_envs = config.num_envs_per_env_runner
        maker = config.env_maker()
        # envs that expose a natively-vectorized constructor (classmethod
        # make_vec(num_envs, config) -> object with reset/step/close batched
        # over envs) skip SyncVectorEnv's per-env Python step loop
        if isinstance(config.env, type) and hasattr(config.env, "make_vec"):
            self.env = config.env.make_vec(self.num_envs, dict(config.env_config))
        else:
            gym = import_gymnasium(f"stepping {config.env!r} without make_vec")
            self.env = gym.vector.SyncVectorEnv([maker for _ in range(self.num_envs)])
        single_env = maker()
        self.module = RLModuleSpec(
            module_class=config.rl_module_class,
            observation_space=single_env.observation_space,
            action_space=single_env.action_space,
            model_config=config.model_config,
        ).build()
        single_env.close()
        self.params = self.module.init_params(seed=config.seed or 0)
        self.rng = np.random.default_rng((config.seed or 0) + worker_index + 1)
        self._episodes: List[SingleAgentEpisode] = []
        self._obs = None
        self.metrics: Dict[str, Any] = {}

    # -- weights --------------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {"params": self.params}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = state["params"]

    def set_weights(self, params) -> None:
        self.params = params

    # -- sampling -------------------------------------------------------------
    def _reset_if_needed(self):
        if self._obs is None:
            obs, _ = self.env.reset(seed=(self.config.seed or 0) + self.worker_index)
            self._obs = obs
            self._episodes = [SingleAgentEpisode() for _ in range(self.num_envs)]
            self._prev_done = np.zeros(self.num_envs, dtype=bool)
            for i in range(self.num_envs):
                self._episodes[i].add_env_reset(obs[i])

    def sample(
        self,
        num_timesteps: Optional[int] = None,
        explore: bool = True,
    ) -> List[Dict[str, np.ndarray]]:
        """Roll out >= num_timesteps env steps; return finished+chunked episodes as dicts."""
        num_timesteps = num_timesteps or self.config.rollout_fragment_length * self.num_envs
        self._reset_if_needed()
        done_eps: List[SingleAgentEpisode] = []
        steps = 0
        dist = self.module.action_dist_cls
        returns: List[float] = []
        while steps < num_timesteps:
            out = self.module.forward_exploration(self.params, {Columns.OBS: self._obs})
            dist_inputs = out[Columns.ACTION_DIST_INPUTS]
            if explore:
                actions = dist.sample_np(dist_inputs, self.rng)
            else:
                actions = dist.greedy_np(dist_inputs)
            logp = dist.logp_np(dist_inputs, actions)
            obs, rewards, terms, truncs, _ = self.env.step(actions)
            for i in range(self.num_envs):
                if self._prev_done[i]:
                    # gymnasium 1.x next-step autoreset: this step reset env i and
                    # ignored the action — obs[i] is the new episode's first obs.
                    self._episodes[i] = SingleAgentEpisode()
                    self._episodes[i].add_env_reset(obs[i])
                    self._prev_done[i] = False
                    continue
                ep = self._episodes[i]
                ep.add_env_step(
                    obs[i], actions[i], rewards[i], terms[i], truncs[i],
                    extra={
                        Columns.ACTION_LOGP: logp[i],
                        Columns.VF_PREDS: out[Columns.VF_PREDS][i],
                    },
                )
                steps += 1
                if terms[i] or truncs[i]:
                    returns.append(ep.get_return())
                    done_eps.append(ep)
                    self._prev_done[i] = True
            self._obs = obs
        # flush in-progress chunks (not done -> learner bootstraps from next_obs_last)
        for i in range(self.num_envs):
            if not self._prev_done[i] and len(self._episodes[i]):
                done_eps.append(self._episodes[i])
                self._episodes[i] = SingleAgentEpisode()
                self._episodes[i].add_env_reset(self._obs[i])
        self.metrics = {
            "num_env_steps_sampled": steps,
            "episode_return_mean": float(np.mean(returns)) if returns else None,
            "num_episodes": len(returns),
        }
        return [ep.to_numpy() for ep in done_eps]

    def get_metrics(self) -> Dict[str, Any]:
        return self.metrics

    def stop(self) -> None:
        self.env.close()
