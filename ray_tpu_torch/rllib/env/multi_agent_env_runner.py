"""MultiAgentEnvRunner: the rollout worker of a MultiAgentEnv (port of
ray_tpu/rllib/env/multi_agent_env_runner.py, numpy, copied as it is).

Capability parity: reference rllib/env/multi_agent_env_runner.py — steps one
MultiAgentEnv, batches per-module inference across the agents mapped to that
module (policy_mapping_fn), builds per-agent episodes, returns them grouped by
module id for the learner. It runs on the host in numpy: each module's
``apply_np`` and its distribution's ``sample_np`` pick the actions, so with
the same seed and weights the samples equal the JAX runner's bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.rl_module import Columns
from .episode import SingleAgentEpisode


class MultiAgentEpisode:
    """Per-agent SingleAgentEpisodes sharing one env episode (reference
    rllib/env/multi_agent_episode.py, append-as-you-step form)."""

    def __init__(self, agent_ids):
        self.agent_episodes: Dict[Any, SingleAgentEpisode] = {a: SingleAgentEpisode() for a in agent_ids}
        self.consumed_return = 0.0  # returns of per-agent chunks already handed to the learner

    def get_return(self) -> float:
        return self.consumed_return + float(sum(e.get_return() for e in self.agent_episodes.values()))


class MultiAgentEnvRunner:
    def __init__(self, config: "AlgorithmConfig", worker_index: int = 0):  # noqa: F821
        self.config = config
        self.worker_index = worker_index
        self.env = config.env_maker()()
        self.mapping_fn = config.policy_mapping_fn
        # one module per policy id, spaces from config.policies or env probe
        self.modules: Dict[str, Any] = {}
        self.params: Dict[str, Any] = {}
        for mid, spec in config.resolved_policy_specs(self.env).items():
            self.modules[mid] = spec.build()
            self.params[mid] = self.modules[mid].init_params(seed=(config.seed or 0))
        self.rng = np.random.default_rng((config.seed or 0) + worker_index + 1)
        self._obs: Optional[Dict] = None
        self._ma_episode: Optional[MultiAgentEpisode] = None
        self.metrics: Dict[str, Any] = {}

    # -- weights --------------------------------------------------------------
    def set_weights(self, params_by_mid: Dict[str, Any]) -> None:
        for mid, p in params_by_mid.items():
            self.params[mid] = p

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.params}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = state["params"]

    # -- sampling -------------------------------------------------------------
    def _reset(self):
        obs, _ = self.env.reset(seed=int(self.rng.integers(1 << 30)))
        self._obs = obs
        self._ma_episode = MultiAgentEpisode(list(obs))
        for aid, o in obs.items():
            self._ma_episode.agent_episodes[aid].add_env_reset(o)

    def sample(self, num_timesteps: Optional[int] = None, explore: bool = True) -> Dict[str, List[Dict[str, np.ndarray]]]:
        """Rollout >= num_timesteps agent-steps; return episode dicts grouped by module."""
        num_timesteps = num_timesteps or self.config.rollout_fragment_length
        if self._obs is None:
            self._reset()
        out: Dict[str, List[Dict[str, np.ndarray]]] = {mid: [] for mid in self.modules}
        returns: List[float] = []
        steps = 0
        while steps < num_timesteps:
            # group live agents by module for batched inference
            by_mid: Dict[str, List[Any]] = {}
            for aid in self._obs:
                by_mid.setdefault(self.mapping_fn(aid), []).append(aid)
            actions: Dict[Any, Any] = {}
            extras: Dict[Any, Dict] = {}
            for mid, aids in by_mid.items():
                module = self.modules[mid]
                obs_b = np.stack([np.asarray(self._obs[a], np.float32).reshape(-1) for a in aids])
                mout = module.apply_np(self.params[mid], obs_b)
                dist = module.action_dist_cls
                di = mout[Columns.ACTION_DIST_INPUTS]
                acts = dist.sample_np(di, self.rng) if explore else dist.greedy_np(di)
                logp = dist.logp_np(di, acts)
                for j, a in enumerate(aids):
                    actions[a] = acts[j]
                    extras[a] = {Columns.ACTION_LOGP: logp[j], Columns.VF_PREDS: mout[Columns.VF_PREDS][j]}
            obs, rewards, terms, truncs, _ = self.env.step(actions)
            for aid in actions:
                if aid not in rewards:
                    continue
                ep = self._ma_episode.agent_episodes[aid]
                done_a = bool(terms.get(aid, False)) or bool(truncs.get(aid, False))
                nxt = obs.get(aid, self._obs[aid])
                ep.add_env_step(nxt, actions[aid], rewards[aid], terms.get(aid, False),
                                truncs.get(aid, False), extra=extras[aid])
                steps += 1
                if done_a:
                    out[self.mapping_fn(aid)].append(ep.to_numpy())
                    self._ma_episode.consumed_return += ep.get_return()
                    self._ma_episode.agent_episodes[aid] = SingleAgentEpisode()  # consumed
            if terms.get("__all__") or truncs.get("__all__"):
                returns.append(self._ma_episode.get_return())
                self._reset()
            else:
                self._obs = {a: o for a, o in obs.items()}
                # agents may join mid-episode (turn-based / spawn envs), or a
                # consumed (done) agent id may re-spawn with a fresh episode
                for aid, o in self._obs.items():
                    ep = self._ma_episode.agent_episodes.get(aid)
                    if ep is None or not ep.observations:
                        ep = SingleAgentEpisode()
                        ep.add_env_reset(o)
                        self._ma_episode.agent_episodes[aid] = ep
        # flush in-progress agent chunks (bootstrap from their last obs)
        for aid, ep in self._ma_episode.agent_episodes.items():
            if len(ep):
                out[self.mapping_fn(aid)].append(ep.to_numpy())
                self._ma_episode.consumed_return += ep.get_return()
                last_obs = ep.observations[-1]
                self._ma_episode.agent_episodes[aid] = SingleAgentEpisode()
                self._ma_episode.agent_episodes[aid].add_env_reset(last_obs)
        self.metrics = {
            "num_env_steps_sampled": steps,
            "episode_return_mean": float(np.mean(returns)) if returns else None,
            "num_episodes": len(returns),
        }
        return out

    def get_metrics(self) -> Dict[str, Any]:
        return self.metrics

    def stop(self) -> None:
        self.env.close()
