"""Action distributions (port of ray_tpu/rllib/core/distributions.py).

Logits come from the RLModule. Sampling happens on the host in the env
runners (numpy, the ``*_np`` methods, copied as they are); log-probabilities
and entropies are taken on the learner's device (``*_torch``, on tensors, in
place of the JAX package's ``*_jax``).

``SquashedGaussian`` (SAC) and ``EpsilonGreedyQ`` (DQN) come with their
algorithms (ROADMAP A9e).
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Distribution:
    @staticmethod
    def sample_np(dist_inputs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def logp_np(dist_inputs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def logp_torch(dist_inputs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def entropy_torch(dist_inputs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Categorical(Distribution):
    """Discrete actions; dist_inputs = logits [B, n]."""

    @staticmethod
    def sample_np(logits: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        z = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        cum = np.cumsum(p, axis=-1)
        r = rng.random(size=(len(p), 1))
        # float32 cum[-1] can be slightly < 1.0; clamp so r in the tail stays in range
        return np.minimum((r > cum).sum(axis=-1), p.shape[-1] - 1).astype(np.int64)

    @staticmethod
    def logp_np(logits: np.ndarray, actions: np.ndarray) -> np.ndarray:
        z = logits - logits.max(axis=-1, keepdims=True)
        logz = np.log(np.exp(z).sum(axis=-1))
        return z[np.arange(len(z)), actions.astype(np.int64)] - logz

    @staticmethod
    def logp_torch(logits, actions):
        lp = torch.log_softmax(logits, dim=-1)
        return lp.gather(-1, actions.long()[..., None])[..., 0]

    @staticmethod
    def entropy_torch(logits):
        lp = torch.log_softmax(logits, dim=-1)
        return -(torch.softmax(logits, dim=-1) * lp).sum(-1)

    @staticmethod
    def greedy_np(logits: np.ndarray) -> np.ndarray:
        return logits.argmax(axis=-1)


class DiagGaussian(Distribution):
    """Continuous actions; dist_inputs = [mean, log_std] concat on last dim [B, 2*d]."""

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 2
        return x[..., :d], x[..., d:]

    @staticmethod
    def sample_np(inputs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        mean, log_std = DiagGaussian._split(inputs)
        return mean + np.exp(log_std) * rng.standard_normal(mean.shape)

    @staticmethod
    def logp_np(inputs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        mean, log_std = DiagGaussian._split(inputs)
        var = np.exp(2 * log_std)
        return (-0.5 * ((actions - mean) ** 2 / var + 2 * log_std + np.log(2 * np.pi))).sum(-1)

    @staticmethod
    def logp_torch(inputs, actions):
        mean, log_std = DiagGaussian._split(inputs)
        var = torch.exp(2 * log_std)
        return (-0.5 * ((actions - mean) ** 2 / var + 2 * log_std
                        + math.log(2 * math.pi))).sum(-1)

    @staticmethod
    def entropy_torch(inputs):
        _, log_std = DiagGaussian._split(inputs)
        return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)

    @staticmethod
    def greedy_np(inputs: np.ndarray) -> np.ndarray:
        mean, _ = DiagGaussian._split(inputs)
        return mean
