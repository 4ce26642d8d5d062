"""Action distributions (port of ray_tpu/rllib/core/distributions.py).

Logits come from the RLModule. Sampling happens on the host in the env
runners (numpy, the ``*_np`` methods, copied as they are); log-probabilities
and entropies are taken on the learner's device (``*_torch``, on tensors, in
place of the JAX package's ``*_jax``).
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


LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
# numeric guards for the tanh change-of-variables (shared by every squashed-logp path)
TANH_CLIP = 0.999999
SQUASH_EPS = 1e-9


def squashed_logp_from_u_torch(u, t, mu, log_std, low, high):
    """log p(a) for a = low + (tanh(u)+1)/2*(high-low), u ~ N(mu, exp(log_std)).

    THE single torch implementation of the tanh-Gaussian change of variables
    (the JAX package's ``squashed_logp_from_u_jax``) — used by
    SquashedGaussian.logp_torch and SACModule.sample_action_torch so the
    learner's and the reparameterized actor's log-probs cannot drift.
    """
    std = torch.exp(log_std)
    span = (high - low) * 0.5
    base = -0.5 * (((u - mu) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))
    corr = torch.log(torch.clamp(span * (1 - t**2), min=SQUASH_EPS))
    return (base - corr).sum(-1)


class SquashedGaussian(Distribution):
    """tanh-squashed diagonal Gaussian scaled to the action bounds (SAC).

    dist_inputs: [B, 4A] — mu, log_std, low, high (bounds ride the inputs the
    same way EpsilonGreedyQ carries epsilon, keeping the distribution stateless).
    """

    @staticmethod
    def _split(x):
        a = x.shape[-1] // 4
        return x[..., :a], np.clip(x[..., a:2 * a], LOG_STD_MIN, LOG_STD_MAX), \
            x[..., 2 * a:3 * a], x[..., 3 * a:]

    @staticmethod
    def _scale(u, low, high):
        return low + (np.tanh(u) + 1.0) * 0.5 * (high - low)

    @staticmethod
    def sample_np(inputs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        mu, log_std, low, high = SquashedGaussian._split(inputs)
        u = mu + np.exp(log_std) * rng.standard_normal(mu.shape)
        return SquashedGaussian._scale(u, low, high).astype(np.float32)

    @staticmethod
    def greedy_np(inputs: np.ndarray) -> np.ndarray:
        mu, _, low, high = SquashedGaussian._split(inputs)
        return SquashedGaussian._scale(mu, low, high).astype(np.float32)

    @staticmethod
    def logp_np(inputs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        mu, log_std, low, high = SquashedGaussian._split(inputs)
        span = (high - low) * 0.5
        t = np.clip((actions - low) / np.maximum(high - low, 1e-9) * 2 - 1,
                    -0.999999, 0.999999)
        u = np.arctanh(t)
        std = np.exp(log_std)
        base = -0.5 * (((u - mu) / std) ** 2 + 2 * log_std + np.log(2 * np.pi))
        # change of variables: da = span * (1 - tanh(u)^2) du
        corr = np.log(np.maximum(span * (1 - t**2), 1e-9))
        return (base - corr).sum(-1).astype(np.float32)

    @staticmethod
    def logp_torch(inputs, actions):
        a = inputs.shape[-1] // 4
        mu = inputs[..., :a]
        log_std = torch.clamp(inputs[..., a:2 * a], LOG_STD_MIN, LOG_STD_MAX)
        low, high = inputs[..., 2 * a:3 * a], inputs[..., 3 * a:]
        t = torch.clamp((actions - low) / torch.clamp(high - low, min=SQUASH_EPS) * 2 - 1,
                        -TANH_CLIP, TANH_CLIP)
        return squashed_logp_from_u_torch(torch.atanh(t), t, mu, log_std, low, high)

    @staticmethod
    def entropy_torch(inputs):
        a = inputs.shape[-1] // 4
        log_std = torch.clamp(inputs[..., a:2 * a], LOG_STD_MIN, LOG_STD_MAX)
        # pre-squash gaussian entropy (the squash correction has no closed form)
        return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


class EpsilonGreedyQ(Distribution):
    """Epsilon-greedy over Q-values (DQN exploration).

    dist_inputs: [B, A+1] — Q-values with the CURRENT epsilon appended as the
    last column (the module owns epsilon as a non-trained parameter so the
    schedule rides the normal weight-sync path to env runners)."""

    @staticmethod
    def sample_np(inputs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        q, eps = inputs[:, :-1], float(inputs[0, -1])
        greedy = q.argmax(axis=-1)
        rand = rng.integers(0, q.shape[1], size=len(q))
        take_rand = rng.random(len(q)) < eps
        return np.where(take_rand, rand, greedy)

    @staticmethod
    def greedy_np(inputs: np.ndarray) -> np.ndarray:
        return inputs[:, :-1].argmax(axis=-1)

    @staticmethod
    def logp_np(inputs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        return np.zeros(len(actions), np.float32)  # DQN losses never use logp

    @staticmethod
    def logp_torch(inputs, actions):
        return torch.zeros(inputs.shape[0], dtype=torch.float32, device=inputs.device)

    @staticmethod
    def entropy_torch(inputs):
        return torch.zeros(inputs.shape[0], dtype=torch.float32, device=inputs.device)


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
