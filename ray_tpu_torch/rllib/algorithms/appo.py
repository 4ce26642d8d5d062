"""APPO: asynchronous PPO — IMPALA's architecture with PPO's clipped surrogate
(port of ray_tpu/rllib/algorithms/appo.py).

Capability parity: reference rllib/algorithms/appo/appo.py — IMPALA's lagged
sampling and V-trace advantages with the policy loss swapped for the PPO
clip objective against the behaviour policy (the policy that generated the
rollout, so no separate target net is needed for the surrogate).
`use_kl_loss` adds the adaptive KL penalty: after each update the
coefficient grows by 1.5x when the KL is above twice `kl_target` and halves
when it is below half of it (the JAX package's update; reference appo.py
update_kl / after_train_step). The coefficient rides in the batch as an f32
scalar and in the learner's state as ``kl_coeff``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .impala import IMPALA, IMPALAConfig, IMPALALearner


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or APPO)
        self.clip_param: float = 0.4
        self.use_kl_loss: bool = False
        self.kl_coeff: float = 0.2
        self.kl_target: float = 0.01

    def training(self, *, clip_param=None, use_kl_loss=None, kl_coeff=None, kl_target=None,
                 **kwargs):
        for k, v in dict(clip_param=clip_param, use_kl_loss=use_kl_loss,
                         kl_coeff=kl_coeff, kl_target=kl_target).items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


class APPOLearner(IMPALALearner):
    def build(self) -> None:
        super().build()
        self._kl_coeff = float(self.config.kl_coeff)

    def _pg_loss(self, target_logp, behaviour_logp, pg_adv, mask, n, kl_coeff):
        cfg = self.config
        ratio = torch.exp(target_logp - behaviour_logp) * mask
        surr1 = ratio * pg_adv
        surr2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * pg_adv
        loss = -(torch.minimum(surr1, surr2)).sum() / n
        if cfg.use_kl_loss:
            kl = ((behaviour_logp - target_logp) * mask).sum() / n
            loss = loss + kl_coeff * kl
        return loss

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        cfg = self.config
        if cfg.use_kl_loss:
            batch = {**batch, "kl_coeff": np.asarray(self._kl_coeff, np.float32)}
        metrics = super().update(batch)
        if cfg.use_kl_loss:
            kl = metrics.get("mean_kl", 0.0)
            if kl > 2.0 * cfg.kl_target:
                self._kl_coeff *= 1.5
            elif kl < 0.5 * cfg.kl_target:
                self._kl_coeff *= 0.5
            metrics["kl_coeff"] = self._kl_coeff
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["kl_coeff"] = self._kl_coeff
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if state.get("kl_coeff") is not None:
            self._kl_coeff = float(state["kl_coeff"])


class APPO(IMPALA):
    learner_class = APPOLearner

    @classmethod
    def get_default_config(cls) -> APPOConfig:
        return APPOConfig(cls)
