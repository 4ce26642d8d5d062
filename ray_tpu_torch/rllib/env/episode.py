"""SingleAgentEpisode: one (chunk of an) env trajectory (port of
ray_tpu/rllib/env/episode.py, numpy, copied as it is).

Capability parity: reference rllib/env/single_agent_episode.py — append-as-you-step
storage, terminated/truncated flags, extra model outputs (logp, vf), numpy conversion.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SingleAgentEpisode:
    observations: List[np.ndarray] = dataclasses.field(default_factory=list)  # T+1
    actions: List[np.ndarray] = dataclasses.field(default_factory=list)  # T
    rewards: List[float] = dataclasses.field(default_factory=list)  # T
    terminated: bool = False
    truncated: bool = False
    extra_model_outputs: Dict[str, List] = dataclasses.field(default_factory=dict)

    def add_env_reset(self, obs) -> None:
        self.observations.append(np.asarray(obs))

    def add_env_step(self, obs, action, reward, terminated=False, truncated=False, extra: Optional[Dict] = None) -> None:
        self.observations.append(np.asarray(obs))
        self.actions.append(np.asarray(action))
        self.rewards.append(float(reward))
        self.terminated = bool(terminated)
        self.truncated = bool(truncated)
        for k, v in (extra or {}).items():
            self.extra_model_outputs.setdefault(k, []).append(v)

    def __len__(self) -> int:
        return len(self.actions)

    @property
    def is_done(self) -> bool:
        return self.terminated or self.truncated

    def get_return(self) -> float:
        return float(sum(self.rewards))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        out = {
            "obs": np.stack(self.observations[:-1]),
            "next_obs_last": np.asarray(self.observations[-1]),
            "actions": np.stack(self.actions),
            "rewards": np.asarray(self.rewards, np.float32),
            "terminated": self.terminated,
            "truncated": self.truncated,
        }
        for k, v in self.extra_model_outputs.items():
            out[k] = np.asarray(v)
        return out
