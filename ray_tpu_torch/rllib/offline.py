"""Offline RL data plane: OfflineData + OfflinePreLearner (port of
ray_tpu/rllib/offline.py; the numpy parts copied as they are).

Capability parity: reference rllib/offline/offline_data.py:30 (OfflineData — sample
batches out of a dataset of recorded transitions) and offline_prelearner.py:55
(OfflinePreLearner — map raw rows to learner-ready train batches, computing returns).

The JAX package reads its input through its data library (ray_tpu/data);
the port reads it itself: ``dataset=`` is any object with ``take_all()``
(row dicts), an ``input_`` ending in ``.json`` is newline-delimited JSON (one
row per line, what ``pyarrow.json.read_json`` reads for the JAX package),
parsed with the standard library, and any other ``input_`` is parquet, read
through pyarrow when it is importable.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

import numpy as np

from .core.rl_module import Columns

# canonical transition columns (reference SampleBatch / offline schema)
SCHEMA = ("obs", "actions", "rewards", "next_obs", "dones", "eps_id")


def episodes_to_rows(episodes: List[Dict[str, np.ndarray]], start_eps_id: int = 0) -> List[Dict[str, Any]]:
    """Flatten env-runner episode dicts into one row per transition (for recording)."""
    rows: List[Dict[str, Any]] = []
    for eid, ep in enumerate(episodes, start=start_eps_id):
        T = len(ep["rewards"])
        obs = np.asarray(ep["obs"], np.float32).reshape(T, -1)
        nxt = np.concatenate([obs[1:], np.asarray(ep["next_obs_last"], np.float32).reshape(1, -1)])
        for t in range(T):
            rows.append({
                "obs": obs[t].tolist(),
                "actions": np.asarray(ep["actions"][t]).tolist(),
                "rewards": float(ep["rewards"][t]),
                "next_obs": nxt[t].tolist(),
                "dones": bool((ep["terminated"]) and t == T - 1),
                "eps_id": int(eid),
                "t": t,
            })
    return rows


class OfflinePreLearner:
    """Rows -> learner batch: groups by episode, adds discounted return-to-go."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def __call__(self, rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        by_ep: Dict[int, List[Dict[str, Any]]] = {}
        for r in rows:
            by_ep.setdefault(int(r.get("eps_id", 0)), []).append(r)
        obs, actions, rewards, next_obs, dones, rtg = [], [], [], [], [], []
        for _, ep_rows in sorted(by_ep.items()):
            ep_rows.sort(key=lambda r: r.get("t", 0))
            g = 0.0
            ep_rtg = np.zeros(len(ep_rows), np.float32)
            for i in range(len(ep_rows) - 1, -1, -1):
                g = float(ep_rows[i]["rewards"]) + self.gamma * g
                ep_rtg[i] = g
            for i, r in enumerate(ep_rows):
                obs.append(np.asarray(r["obs"], np.float32))
                actions.append(np.asarray(r["actions"]))
                rewards.append(float(r["rewards"]))
                next_obs.append(np.asarray(r["next_obs"], np.float32))
                dones.append(float(bool(r["dones"])))
                rtg.append(ep_rtg[i])
        return {
            Columns.OBS: np.stack(obs),
            Columns.ACTIONS: np.stack(actions),
            "rewards": np.asarray(rewards, np.float32),
            "next_obs": np.stack(next_obs),
            "dones": np.asarray(dones, np.float32),
            "returns_to_go": np.asarray(rtg, np.float32),
        }


def _expand_paths(paths) -> List[str]:
    """A path, a list of them, directories (their files, sorted, hidden
    ones skipped) and globs -> the files, as ray_tpu/data/datasource.py
    resolves them."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files) if not f.startswith("."))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files found for {paths}")
    return out


def read_json_rows(paths) -> List[Dict[str, Any]]:
    """Newline-delimited JSON files -> their rows, file by file."""
    rows: List[Dict[str, Any]] = []
    for path in _expand_paths(paths):
        with open(path, encoding="utf-8") as f:
            rows.extend(json.loads(line) for line in f if line.strip())
    return rows


def read_parquet_rows(paths) -> List[Dict[str, Any]]:
    """Parquet files -> their rows, through pyarrow, imported only here."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "reading parquet offline data needs pyarrow, which is not installed; "
            "pass newline-delimited JSON (input_ ending in .json) or dataset= instead") from e
    rows: List[Dict[str, Any]] = []
    for path in _expand_paths(paths):
        rows.extend(pq.read_table(path).to_pylist())
    return rows


class OfflineData:
    """Materialized offline dataset with random minibatch sampling."""

    def __init__(self, config: "AlgorithmConfig", dataset=None):  # noqa: F821
        if dataset is not None or config.input_dataset is not None:
            ds = dataset if dataset is not None else config.input_dataset
            rows = ds.take_all()
        else:
            paths = config.input_
            first = paths[0] if isinstance(paths, (list, tuple)) else paths
            if isinstance(first, str) and first.endswith(".json"):
                rows = read_json_rows(paths)
            else:
                rows = read_parquet_rows(paths)
        pre = OfflinePreLearner(config.gamma)
        self.batch = pre(rows)
        self.n = len(self.batch[Columns.OBS])

    def __len__(self) -> int:
        return self.n

    def sample(self, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.n, size=min(batch_size, self.n))
        return {k: v[idx] for k, v in self.batch.items()}
