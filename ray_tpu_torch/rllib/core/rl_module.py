"""RLModule: the neural-network abstraction (port of ray_tpu/rllib/core/rl_module.py).

A module is an (init, apply) pair over a parameter tree of dicts and lists.
The same tree runs on the host (numpy, ``apply_np``: the env runners and the
GAE bootstrap) and on the learner's device (torch, ``apply_torch``).
``init_params`` draws the JAX package's numpy tree from the same seed, so
``params_from_numpy`` / ``to_numpy`` carry weights and states between the
two packages unchanged.

Spaces are told apart without gymnasium: a discrete space has an integer
``n`` (``is_discrete``), a Box has ``low``, ``high`` and ``shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device

from .distributions import (LOG_STD_MAX, LOG_STD_MIN, Categorical, DiagGaussian,
                            EpsilonGreedyQ, SquashedGaussian, squashed_logp_from_u_torch)

Columns = type("Columns", (), {
    "OBS": "obs",
    "ACTIONS": "actions",
    "REWARDS": "rewards",
    "TERMINATEDS": "terminateds",
    "TRUNCATEDS": "truncateds",
    "ACTION_DIST_INPUTS": "action_dist_inputs",
    "ACTION_LOGP": "action_logp",
    "VF_PREDS": "vf_preds",
    "ADVANTAGES": "advantages",
    "VALUE_TARGETS": "value_targets",
})


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples, in jax.tree_util's
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(like, leaves: List[Any]):
    """A tree shaped as `like` holding `leaves` (in tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def params_from_numpy(tree, device=None):
    """A numpy parameter tree (the JAX package's ``init_params`` or
    ``Learner.get_weights``) -> the same tree of f32 tensors on `device`
    (the card unless the CPU is asked for), each a copy."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev),
                    tree)


def to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays, each a copy."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


@dataclasses.dataclass
class RLModuleSpec:
    """Reference rl_module.py RLModuleSpec: how to build the module."""

    module_class: Optional[type] = None
    observation_space: Any = None
    action_space: Any = None
    model_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self) -> "RLModule":
        cls = self.module_class or MLPModule
        return cls(self.observation_space, self.action_space, self.model_config)


class RLModule:
    """forward_* operate on dict batches and return dict outputs."""

    def __init__(self, observation_space, action_space, model_config: Dict[str, Any]):
        self.observation_space = observation_space
        self.action_space = action_space
        self.model_config = dict(model_config or {})

    # -- abstract -------------------------------------------------------------
    def init_params(self, seed: int = 0) -> Any:
        raise NotImplementedError

    def apply_torch(self, params: Any, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Device-side forward (tensors in and out); used by the learner."""
        raise NotImplementedError

    def apply_np(self, params: Any, obs: np.ndarray) -> Dict[str, np.ndarray]:
        """Host-side forward (numpy); used by env runners."""
        raise NotImplementedError

    @property
    def action_dist_cls(self):
        raise NotImplementedError

    # -- RLModule API shape ----------------------------------------------------
    def forward_inference(self, params, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.apply_np(params, batch[Columns.OBS])

    def forward_exploration(self, params, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.apply_np(params, batch[Columns.OBS])

    def forward_train(self, params, batch: Dict[str, Any]) -> Dict[str, Any]:
        return self.apply_torch(params, batch[Columns.OBS])


def _mlp_init(rng: np.random.Generator, sizes) -> list:
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        scale = np.sqrt(2.0 / fan_in)
        layers.append({
            "w": (rng.standard_normal((fan_in, fan_out)) * scale).astype(np.float32),
            "b": np.zeros((fan_out,), np.float32),
        })
    return layers


def _mlp_apply_np(layers, x: np.ndarray, final_linear: bool = True) -> np.ndarray:
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or not final_linear:
            x = np.tanh(x)
    return x


def _mlp_apply_torch(layers, x: torch.Tensor, final_linear: bool = True) -> torch.Tensor:
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


def is_discrete(space) -> bool:
    """A discrete action space has an integer ``n`` (gymnasium's Discrete
    does, Box does not), so no gymnasium import is needed to tell them apart."""
    return isinstance(getattr(space, "n", None), (int, np.integer))


def is_box(space) -> bool:
    """A Box has bounds and a shape (gymnasium's Box does); a discrete space
    is no Box."""
    return not is_discrete(space) and all(
        hasattr(space, k) for k in ("low", "high", "shape"))


class MLPModule(RLModule):
    """Default policy+value MLP (reference catalog default: separate pi/vf trunks)."""

    def __init__(self, observation_space, action_space, model_config):
        super().__init__(observation_space, action_space, model_config)
        self.hiddens = tuple(model_config.get("fcnet_hiddens", (64, 64)))
        self.obs_dim = int(np.prod(observation_space.shape))
        if is_discrete(action_space):
            self.out_dim = int(action_space.n)
            self._dist_cls = Categorical
        else:
            self.act_dim = int(np.prod(action_space.shape))
            self.out_dim = 2 * self.act_dim
            self._dist_cls = DiagGaussian

    @property
    def action_dist_cls(self):
        return self._dist_cls

    def init_params(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        pi = _mlp_init(rng, (self.obs_dim, *self.hiddens, self.out_dim))
        # near-zero final policy layer -> near-uniform initial policy
        pi[-1]["w"] *= 0.01
        vf = _mlp_init(rng, (self.obs_dim, *self.hiddens, 1))
        return {"pi": pi, "vf": vf}

    def apply_np(self, params, obs):
        obs = obs.reshape(len(obs), -1).astype(np.float32)
        logits = _mlp_apply_np(params["pi"], obs)
        vf = _mlp_apply_np(params["vf"], obs)[..., 0]
        return {Columns.ACTION_DIST_INPUTS: logits, Columns.VF_PREDS: vf}

    def apply_torch(self, params, obs):
        obs = obs.reshape(len(obs), -1)
        logits = _mlp_apply_torch(params["pi"], obs)
        vf = _mlp_apply_torch(params["vf"], obs)[..., 0]
        return {Columns.ACTION_DIST_INPUTS: logits, Columns.VF_PREDS: vf}


class SACModule(RLModule):
    """Squashed-Gaussian policy + twin Q critics for continuous control (SAC).

    Params: {"pi": mlp(obs -> 2A), "q1"/"q2": mlp([obs, act] -> 1),
    "log_alpha": scalar temperature (auto-tuned by the learner)}.
    """

    def __init__(self, observation_space, action_space, model_config):
        super().__init__(observation_space, action_space, model_config)
        if not is_box(action_space):
            raise ValueError("SACModule requires a Box action space")
        self.hiddens = tuple(model_config.get("fcnet_hiddens", (64, 64)))
        self.obs_dim = int(np.prod(observation_space.shape))
        self.act_dim = int(np.prod(action_space.shape))
        self.low = np.asarray(action_space.low, np.float32).reshape(-1)
        self.high = np.asarray(action_space.high, np.float32).reshape(-1)
        if not (np.isfinite(self.low).all() and np.isfinite(self.high).all()):
            raise ValueError(
                "SACModule requires finite action bounds (tanh squashing scales to "
                "[low, high]); wrap the env with a bounded Box action space")
        self._bounds: Dict[torch.device, Any] = {}

    @property
    def action_dist_cls(self):
        return SquashedGaussian

    def init_params(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        return {
            "pi": _mlp_init(rng, (self.obs_dim, *self.hiddens, 2 * self.act_dim)),
            "q1": _mlp_init(rng, (self.obs_dim + self.act_dim, *self.hiddens, 1)),
            "q2": _mlp_init(rng, (self.obs_dim + self.act_dim, *self.hiddens, 1)),
            "log_alpha": np.float32(0.0),
        }

    def _bounds_np(self, b):
        return (np.broadcast_to(self.low, (b, self.act_dim)),
                np.broadcast_to(self.high, (b, self.act_dim)))

    def bounds_torch(self, device):
        """(low, high) as [A] f32 tensors on `device`, made once per device."""
        device = torch.device(device)
        if device not in self._bounds:
            self._bounds[device] = (torch.from_numpy(self.low).to(device),
                                    torch.from_numpy(self.high).to(device))
        return self._bounds[device]

    def apply_np(self, params, obs):
        obs = obs.reshape(len(obs), -1).astype(np.float32)
        out = _mlp_apply_np(params["pi"], obs)
        low, high = self._bounds_np(len(obs))
        return {
            Columns.ACTION_DIST_INPUTS: np.concatenate([out, low, high], axis=1),
            Columns.VF_PREDS: np.zeros(len(obs), np.float32),
        }

    def apply_torch(self, params, obs):
        obs = obs.reshape(len(obs), -1)
        out = _mlp_apply_torch(params["pi"], obs)
        low, high = self.bounds_torch(out.device)
        b = out.shape[0]
        return {
            Columns.ACTION_DIST_INPUTS: torch.cat(
                [out, low.expand(b, -1), high.expand(b, -1)], dim=1),
            Columns.VF_PREDS: torch.zeros(b, dtype=torch.float32, device=out.device),
        }

    # -- learner-side pieces -----------------------------------------------------
    def pi_torch(self, params, obs):
        """(mu, log_std) of the pre-squash Gaussian."""
        out = _mlp_apply_torch(params["pi"], obs.reshape(len(obs), -1))
        mu, log_std = out[..., : self.act_dim], out[..., self.act_dim:]
        return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample_action_torch(self, params, obs, noise):
        """Reparameterized squashed sample + its log-prob (for actor/critic
        losses). `noise` is the standard normal draw, [len(obs), A]: the
        caller owns the random numbers (the JAX package's jax.random key)."""
        mu, log_std = self.pi_torch(params, obs)
        u = mu + torch.exp(log_std) * noise
        t = torch.tanh(u)
        low, high = self.bounds_torch(mu.device)
        action = low + (t + 1.0) * 0.5 * (high - low)
        return action, squashed_logp_from_u_torch(u, t, mu, log_std, low, high)

    def q_torch(self, params, which, obs, actions):
        x = torch.cat([obs.reshape(len(obs), -1), actions], dim=-1)
        return _mlp_apply_torch(params[which], x)[..., 0]


class DQNModule(RLModule):
    """Q-network for discrete actions (reference dqn_rainbow_rl_module).

    Params carry a non-trained "epsilon" leaf: its task-loss gradient is exactly
    zero (loss never reads it), so the optimizer leaves it alone, and the DQN
    algorithm overwrites it per the schedule before syncing weights to runners —
    exploration state rides the ordinary weight-sync path."""

    def __init__(self, observation_space, action_space, model_config):
        super().__init__(observation_space, action_space, model_config)
        if not is_discrete(action_space):
            raise ValueError("DQNModule requires a Discrete action space")
        self.hiddens = tuple(model_config.get("fcnet_hiddens", (64, 64)))
        self.obs_dim = int(np.prod(observation_space.shape))
        self.num_actions = int(action_space.n)

    @property
    def action_dist_cls(self):
        return EpsilonGreedyQ

    def init_params(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        q = _mlp_init(rng, (self.obs_dim, *self.hiddens, self.num_actions))
        return {"q": q, "epsilon": np.float32(1.0)}

    def q_values_np(self, params, obs: np.ndarray) -> np.ndarray:
        obs = obs.reshape(len(obs), -1).astype(np.float32)
        return _mlp_apply_np(params["q"], obs)

    def q_values_torch(self, params, obs):
        obs = obs.reshape(len(obs), -1)
        return _mlp_apply_torch(params["q"], obs)

    def apply_np(self, params, obs):
        q = self.q_values_np(params, obs)
        eps = np.full((len(q), 1), float(params["epsilon"]), np.float32)
        return {
            Columns.ACTION_DIST_INPUTS: np.concatenate([q, eps], axis=1),
            Columns.VF_PREDS: q.max(axis=-1),
        }

    def apply_torch(self, params, obs):
        q = self.q_values_torch(params, obs)
        eps = params["epsilon"].expand(q.shape[0], 1)
        return {
            Columns.ACTION_DIST_INPUTS: torch.cat([q, eps], dim=1),
            Columns.VF_PREDS: q.max(dim=-1).values,
        }
