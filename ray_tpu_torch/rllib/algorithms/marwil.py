"""MARWIL: monotonic advantage re-weighted imitation learning (+ BC as beta=0)
(port of ray_tpu/rllib/algorithms/marwil.py).

Capability parity: reference rllib/algorithms/marwil/ — exponentially
advantage-weighted behavior cloning with a learned value baseline; the reference's
BC algorithm is literally MARWIL with beta=0 (rllib/algorithms/bc/bc.py), mirrored
here. Offline input via OfflineData (newline-JSON, parquet, or a dataset object).
The learner runs the base class's minibatch SGD on its device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import Learner
from ..core.rl_module import Columns
from ..offline import OfflineData
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or MARWIL)
        self.beta: float = 1.0  # 0 => plain behavior cloning
        self.vf_coeff: float = 1.0
        self.moving_average_sqd_adv_norm_update_rate: float = 1e-8  # kept for API parity
        self.num_updates_per_iteration: int = 32
        self.train_batch_size = 512
        self.num_epochs = 1

    def training(self, *, beta=None, vf_coeff=None, num_updates_per_iteration=None, **kwargs):
        for k, v in dict(beta=beta, vf_coeff=vf_coeff,
                         num_updates_per_iteration=num_updates_per_iteration).items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


class MARWILLearner(Learner):
    def compute_losses(self, params, batch):
        cfg = self.config
        out = self.module.forward_train(params, batch)
        dist = self.module.action_dist_cls
        logp = dist.logp_torch(out[Columns.ACTION_DIST_INPUTS], batch[Columns.ACTIONS])
        vf = out[Columns.VF_PREDS]
        rtg = batch["returns_to_go"]
        vf_loss = torch.mean(torch.square(vf - rtg))
        if cfg.beta > 0.0:
            adv = (rtg - vf).detach()
            # normalize by the batch RMS advantage (reference keeps a moving average)
            adv = adv / torch.clamp(torch.sqrt(torch.mean(torch.square(adv))), min=1e-6)
            weights = torch.clamp(torch.exp(cfg.beta * adv), max=20.0)
        else:
            weights = 1.0
        policy_loss = -torch.mean(weights * logp)
        # under BC the value term stays in the graph with a zero gradient
        total = policy_loss + cfg.vf_coeff * vf_loss * (1.0 if cfg.beta > 0.0 else 0.0)
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "mean_logp": torch.mean(logp)}


class MARWIL(Algorithm):
    learner_class = MARWILLearner

    @classmethod
    def get_default_config(cls) -> MARWILConfig:
        return MARWILConfig(cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self._algo_config
        self.offline_data = OfflineData(cfg)
        self._rng = np.random.default_rng(cfg.seed or 0)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        for _ in range(cfg.num_updates_per_iteration):
            batch = self.offline_data.sample(cfg.train_batch_size, self._rng)
            for lm in self.learner_group.update(batch):
                self.metrics.log_dict(lm)
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return self.metrics.reduce()


class BCConfig(MARWILConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or BC)
        self.beta = 0.0


class BC(MARWIL):
    """Behavior cloning (reference rllib/algorithms/bc/bc.py: MARWIL with beta=0)."""

    @classmethod
    def get_default_config(cls) -> BCConfig:
        return BCConfig(cls)
