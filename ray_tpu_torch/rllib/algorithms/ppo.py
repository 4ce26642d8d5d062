"""PPO: proximal policy optimization (port of ray_tpu/rllib/algorithms/ppo.py).

Capability parity: reference rllib/algorithms/ppo/ppo.py:362 (training_step :388) and
ppo_torch_learner's loss — clipped surrogate + value clip + entropy bonus; GAE in the
learner connector; weight sync back to env runners each iteration (ppo.py:452).
The serialized path: the decoupled rollout plane is ROADMAP A9c.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..connectors import GeneralAdvantageEstimation
from ..core.learner import Learner
from ..core.rl_module import Columns
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or PPO)
        self.lambda_: float = 0.95
        self.clip_param: float = 0.3
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 1.0
        self.entropy_coeff: float = 0.0
        self.kl_coeff: float = 0.0  # ASHA-friendly default: pure clipping, no KL penalty

    def training(self, *, lambda_=None, clip_param=None, vf_clip_param=None,
                 vf_loss_coeff=None, entropy_coeff=None, kl_coeff=None, **kwargs) -> "PPOConfig":
        for k, v in dict(lambda_=lambda_, clip_param=clip_param, vf_clip_param=vf_clip_param,
                         vf_loss_coeff=vf_loss_coeff, entropy_coeff=entropy_coeff, kl_coeff=kl_coeff).items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


class PPOLearner(Learner):
    """PPO loss on tensors (reference ppo_torch_learner.compute_loss_for_module)."""

    def compute_losses(self, params, batch):
        cfg = self.config
        out = self.module.forward_train(params, batch)
        dist = self.module.action_dist_cls
        logits = out[Columns.ACTION_DIST_INPUTS]
        logp = dist.logp_torch(logits, batch[Columns.ACTIONS])
        ratio = torch.exp(logp - batch[Columns.ACTION_LOGP])
        adv = batch[Columns.ADVANTAGES]

        # decoupled trajectory blocks carry a validity mask (vector-env
        # autoreset rows); the serialized path has none -> plain means
        w = batch.get("loss_mask")
        if w is None:
            mmean = torch.mean
        else:
            wsum = torch.clamp(w.sum(), min=1.0)

            def mmean(x):
                return (x * w).sum() / wsum

        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv
        policy_loss = -mmean(torch.minimum(surr1, surr2))

        vf = out[Columns.VF_PREDS]
        vf_err = torch.square(vf - batch[Columns.VALUE_TARGETS])
        vf_loss = mmean(torch.clamp(vf_err, 0.0, cfg.vf_clip_param**2))

        entropy = mmean(dist.entropy_torch(logits))
        total = policy_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        aux = {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_kl": mmean(batch[Columns.ACTION_LOGP] - logp),
        }
        return total, aux


class PPO(Algorithm):
    learner_class = PPOLearner

    @classmethod
    def get_default_config(cls) -> PPOConfig:
        return PPOConfig(cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self._algo_config
        self._gae = GeneralAdvantageEstimation(cfg.gamma, cfg.lambda_)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        # 1. synchronous sampling (ppo.py:397)
        episodes = self.env_runner_group.sample(cfg.train_batch_size)
        for m in self.env_runner_group.get_metrics():
            self.metrics.log_dict({k: v for k, v in m.items() if v is not None}, window=20)
        # 2. learner connector: GAE with host-side bootstrap values (ppo.py:425)
        params = self.learner_group.get_weights()
        batch = self._gae(episodes, module=self._module, params=params)
        # 3. learner update
        learner_metrics = self.learner_group.update(batch)
        for lm in learner_metrics:
            self.metrics.log_dict(lm)
        # 4. sync new weights to env runners (ppo.py:452)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self.metrics.reduce()
        result["num_env_steps_trained"] = len(batch[Columns.OBS])
        return result
