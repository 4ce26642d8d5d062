"""Replay buffers for off-policy algorithms (port of
ray_tpu/rllib/utils/replay_buffer.py: numpy, copied as it is).

Capability parity: reference rllib/utils/replay_buffers/ (EpisodeReplayBuffer,
PrioritizedEpisodeReplayBuffer) — transition-level storage in preallocated numpy
rings, on the host, so a sampled batch is contiguous arrays that the learner
uploads to its device once per update. Storage keeps the env's obs dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ReplayBuffer:
    """Uniform transition replay (ring buffer) with optional n-step returns.

    With n_step > 1 each stored transition is (obs_t, a_t, sum_{k<n} γ^k r_{t+k},
    obs_{t+n}, done-within-window); the learner then bootstraps with γ^n.
    """

    def __init__(self, capacity: int = 100_000, n_step: int = 1, gamma: float = 0.99):
        self.capacity = capacity
        self.n_step = max(1, n_step)
        self.gamma = gamma
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._idx = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def _ensure_storage(self, obs: np.ndarray, actions: np.ndarray) -> None:
        if self._storage is not None:
            return
        obs_shape = obs.shape[1:]
        # action dtype/shape follow the env: int64 scalars (DQN) or float vectors (SAC)
        self._storage = {
            "obs": np.zeros((self.capacity, *obs_shape), obs.dtype),
            "next_obs": np.zeros((self.capacity, *obs_shape), obs.dtype),
            "actions": np.zeros((self.capacity, *actions.shape[1:]), actions.dtype),
            "rewards": np.zeros((self.capacity,), np.float32),
            "dones": np.zeros((self.capacity,), np.float32),
        }

    def _ring_write(self, rows: Dict[str, np.ndarray], t: int) -> None:
        """Write t rows at the ring head with at most two slice assignments/key."""
        first = min(t, self.capacity - self._idx)
        for k, v in rows.items():
            self._storage[k][self._idx:self._idx + first] = v[:first]
            if first < t:
                self._storage[k][: t - first] = v[first:]
        self._idx = (self._idx + t) % self.capacity
        self._size = min(self._size + t, self.capacity)

    def add_episodes(self, episodes: List[Dict[str, np.ndarray]]) -> int:
        """Ingest env-runner episode dicts (episode.py to_numpy format)."""
        added = 0
        n, g = self.n_step, self.gamma
        for ep in episodes:
            obs = ep["obs"]
            t = len(ep["actions"])
            if t == 0:
                continue
            all_obs = np.concatenate([obs, ep["next_obs_last"][None]], axis=0)  # T+1
            rewards = np.asarray(ep["rewards"], np.float32)
            terminal = bool(ep["terminated"])
            # n-step aggregation (window clips at the episode end; only a true
            # terminal inside the window sets done — truncation keeps bootstrapping)
            nr = np.zeros(t, np.float32)
            next_idx = np.minimum(np.arange(t) + n, t)
            for k in range(n):
                valid = np.arange(t) + k < t
                nr[valid] += (g**k) * rewards[k:][: valid.sum()]
            dones = np.zeros(t, np.float32)
            if terminal:
                dones[max(0, t - n):] = 1.0
            actions = np.asarray(ep["actions"])
            if actions.dtype.kind in "iu":
                actions = actions.astype(np.int64)
            rows = {
                "obs": obs,
                "next_obs": all_obs[next_idx],
                "actions": actions,
                "rewards": nr,
                "dones": dones,
            }
            self._ensure_storage(obs, actions)
            if t > self.capacity:  # only the last `capacity` rows can survive anyway
                rows = {k: v[t - self.capacity:] for k, v in rows.items()}
                t = self.capacity
            self._ring_write(rows, t)
            added += t
        return added

    def sample(self, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        idx = rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (Schaul et al.) with IS weights.

    O(n) sampling via cumulative sums — fine for the capacities used here; the
    reference's segment-tree variant is an optimization, not a semantic change.
    """

    def __init__(self, capacity: int = 100_000, n_step: int = 1, gamma: float = 0.99,
                 alpha: float = 0.6, beta: float = 0.4):
        super().__init__(capacity, n_step, gamma)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros((capacity,), np.float32)
        self._max_priority = 1.0

    def add_episodes(self, episodes: List[Dict[str, np.ndarray]]) -> int:
        start = self._idx
        added = super().add_episodes(episodes)
        if added:
            idx = (start + np.arange(added)) % self.capacity
            self._priorities[idx] = self._max_priority
        return added

    def sample(self, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        p = self._priorities[: self._size] ** self.alpha
        p = p / p.sum()
        idx = rng.choice(self._size, size=batch_size, p=p)
        batch = {k: v[idx] for k, v in self._storage.items()}
        w = (self._size * p[idx]) ** (-self.beta)
        batch["weights"] = (w / w.max()).astype(np.float32)
        batch["batch_indexes"] = idx.astype(np.int64)
        return batch

    def update_priorities(self, indexes: np.ndarray, td_errors: np.ndarray) -> None:
        prios = np.abs(td_errors) + 1e-6
        self._priorities[indexes] = prios
        self._max_priority = max(self._max_priority, float(prios.max()))
