"""ConnectorV2 pipelines (port of ray_tpu/rllib/connectors.py: numpy, copied as it
is; the GAE bootstrap runs through the module's host forward ``apply_np``).

Capability parity: reference rllib/connectors/{env_to_module,module_to_env,learner}/ —
composable transforms between env, module, and learner. The learner pipeline implements
GAE (general_advantage_estimation.py) and batching of episode lists.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .core.rl_module import Columns


class ConnectorV2:
    def __call__(self, data: Any, **kwargs) -> Any:
        raise NotImplementedError


class ConnectorPipelineV2(ConnectorV2):
    def __init__(self, connectors: List[ConnectorV2]):
        self.connectors = list(connectors)

    def __call__(self, data: Any, **kwargs) -> Any:
        for c in self.connectors:
            data = c(data, **kwargs)
        return data

    def append(self, c: ConnectorV2) -> None:
        self.connectors.append(c)


class FlattenObs(ConnectorV2):
    """env->module: flatten observations to [B, -1] float32."""

    def __call__(self, batch: Dict[str, np.ndarray], **kw) -> Dict[str, np.ndarray]:
        obs = batch[Columns.OBS]
        batch[Columns.OBS] = obs.reshape(len(obs), -1).astype(np.float32)
        return batch


class GeneralAdvantageEstimation(ConnectorV2):
    """learner pipeline: per-episode GAE(lambda) + value targets, then concat.

    Reference rllib/connectors/learner/general_advantage_estimation.py. Episodes not
    terminated bootstrap from the module's value of the last observation.
    """

    def __init__(self, gamma: float, lambda_: float):
        self.gamma = gamma
        self.lambda_ = lambda_

    def __call__(self, episodes: List[Dict[str, np.ndarray]], *, module=None, params=None, **kw) -> Dict[str, np.ndarray]:
        batches = []
        for ep in episodes:
            T = len(ep["rewards"])
            vf = np.asarray(ep[Columns.VF_PREDS], np.float32)
            rewards = ep["rewards"]
            if ep["terminated"]:
                bootstrap = 0.0
            else:
                out = module.apply_np(params, ep["next_obs_last"][None])
                bootstrap = float(out[Columns.VF_PREDS][0])
            vf_ext = np.append(vf, bootstrap)
            adv = np.zeros(T, np.float32)
            gae = 0.0
            for t in range(T - 1, -1, -1):
                delta = rewards[t] + self.gamma * vf_ext[t + 1] - vf_ext[t]
                gae = delta + self.gamma * self.lambda_ * gae
                adv[t] = gae
            targets = adv + vf
            batches.append({
                Columns.OBS: ep["obs"],
                Columns.ACTIONS: ep["actions"],
                Columns.ACTION_LOGP: np.asarray(ep[Columns.ACTION_LOGP], np.float32),
                Columns.VF_PREDS: vf,
                Columns.ADVANTAGES: adv,
                Columns.VALUE_TARGETS: targets.astype(np.float32),
            })
        out: Dict[str, np.ndarray] = {}
        for k in batches[0]:
            out[k] = np.concatenate([b[k] for b in batches])
        # standardize advantages across the whole train batch (reference ppo default)
        a = out[Columns.ADVANTAGES]
        out[Columns.ADVANTAGES] = (a - a.mean()) / max(a.std(), 1e-6)
        obs = out[Columns.OBS]
        out[Columns.OBS] = obs.reshape(len(obs), -1).astype(np.float32)
        return out
