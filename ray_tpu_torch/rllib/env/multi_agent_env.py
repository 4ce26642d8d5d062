"""MultiAgentEnv: dict-keyed multi-agent environment API (port of
ray_tpu/rllib/env/multi_agent_env.py, numpy, copied as it is).

Capability parity: reference rllib/env/multi_agent_env.py — reset() returns
(obs_dict, info_dict); step(action_dict) returns (obs, rewards, terminateds,
truncateds, infos) dicts keyed by agent id, with the special "__all__" key in
terminateds/truncateds signalling episode end; `make_multi_agent` wraps a
single-agent env into N independent agent copies (the reference's
test/regression workhorse).

A callable maker (an env class such as one with ``make_vec``) needs no
gymnasium; a string env id is made with ``gym.make``, the one place here that
imports gymnasium.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .env_runner import import_gymnasium


class MultiAgentEnv:
    """Subclass and implement reset/step with dict-keyed agents."""

    possible_agents: List[Any] = []

    @property
    def agents(self) -> List[Any]:
        return list(self.possible_agents)

    def reset(self, *, seed: Optional[int] = None, options=None) -> Tuple[Dict, Dict]:
        raise NotImplementedError

    def step(self, action_dict: Dict[Any, Any]) -> Tuple[Dict, Dict, Dict, Dict, Dict]:
        raise NotImplementedError

    def observation_space_for(self, agent_id) -> Any:
        return self.observation_space[agent_id] if isinstance(self.observation_space, dict) else self.observation_space

    def action_space_for(self, agent_id) -> Any:
        return self.action_space[agent_id] if isinstance(self.action_space, dict) else self.action_space

    def close(self) -> None:
        pass


def make_multi_agent(env_name_or_maker) -> Callable[[Dict], MultiAgentEnv]:
    """N independent copies of a single-agent env as agents 0..N-1
    (reference rllib/env/multi_agent_env.py make_multi_agent)."""

    def maker(config: Optional[Dict] = None) -> MultiAgentEnv:
        config = dict(config or {})
        num = int(config.pop("num_agents", 2))

        def make_one():
            if callable(env_name_or_maker):
                return env_name_or_maker(config)
            gym = import_gymnasium(f"gym.make({env_name_or_maker!r})")
            return gym.make(env_name_or_maker, **config)

        return _IndependentCopies([make_one() for _ in range(num)])

    return maker


class _IndependentCopies(MultiAgentEnv):
    def __init__(self, envs):
        self.envs = envs
        self.possible_agents = list(range(len(envs)))
        self.observation_space = envs[0].observation_space
        self.action_space = envs[0].action_space
        self._done = [False] * len(envs)

    def reset(self, *, seed=None, options=None):
        obs, infos = {}, {}
        for i, e in enumerate(self.envs):
            o, info = e.reset(seed=None if seed is None else seed + i, options=options)
            obs[i], infos[i] = o, info
            self._done[i] = False
        return obs, infos

    def step(self, action_dict):
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for i, a in action_dict.items():
            if self._done[i]:
                continue
            o, r, te, tr, info = self.envs[i].step(a)
            obs[i], rewards[i], terms[i], truncs[i], infos[i] = o, r, te, tr, info
            if te or tr:
                self._done[i] = True
        terms["__all__"] = all(self._done)
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, infos

    def close(self):
        for e in self.envs:
            e.close()
