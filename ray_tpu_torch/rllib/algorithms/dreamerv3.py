"""DreamerV3: world-model RL — RSSM + actor-critic trained in imagination (port
of ray_tpu/rllib/algorithms/dreamerv3.py).

Capability parity: reference rllib/algorithms/dreamerv3/ (dreamerv3.py;
torch world-model/actor/critic in dreamerv3/torch/, custom recurrent env
runner in dreamerv3/utils/env_runner.py). The world model (encoder → RSSM
with categorical latents → decoder/reward/continue heads), imagination
rollouts, and the actor and critic updates run on the learner's device (the
card unless the config asks for the CPU) as eager loops over the sequence and
the horizon, where the JAX package jits two scanned programs. The recurrent
env runner and the replay stream stay on the host in numpy.

Key mechanisms kept from the paper/reference:
- RSSM: GRU deterministic path; stochastic state = K categorical distributions
  of C classes with straight-through sampling and 1% uniform mixing (unimix);
- KL balancing with free bits: beta_dyn * max(1, KL(sg(post) || prior)) +
  beta_rep * max(1, KL(post || sg(prior)));
- symlog regression for reconstruction/reward/value;
- imagination: H-step rollouts from replayed posterior states, lambda-returns,
  EMA-regularized critic, REINFORCE actor with return normalization by an EMA
  of the 5th..95th return percentile range;
- replay: one contiguous step stream with is_first markers (windows may span
  episode boundaries; the RSSM resets where is_first=1).

Every categorical draw is ``argmax(logits + gumbel)``, which is what
``jax.random.categorical`` computes; the Gumbel noise is an argument, drawn
from the learner's ``torch.Generator`` (``draw_noise``) or the runner's numpy
generator, so a caller can hand both packages the same noise. ``idx=`` holds
a draw to given picks instead (None on the main path).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.train.optim import AdamWState, adamw_init, adamw_update_, clip_by_global_norm_

from ..core.learner import ADAM_B1, ADAM_B2, ADAM_EPS, Learner, _adam_state
from ..core.rl_module import params_from_numpy, to_numpy, tree_leaves, tree_map, tree_unflatten
from ..env.env_runner import import_gymnasium
from ..env.episode import SingleAgentEpisode
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig

WM_KEYS = ("enc", "gru_r", "gru_u", "gru_c", "prior", "post", "dec", "rew", "cont")


# ------------------------------------------------------------------ helpers

def _symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def _symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _linear(rng: np.random.Generator, n_in: int, n_out: int) -> Dict[str, np.ndarray]:
    scale = np.sqrt(2.0 / max(1, n_in))
    return {"w": (rng.standard_normal((n_in, n_out)) * scale).astype(np.float32),
            "b": np.zeros((n_out,), np.float32)}


def _mlp_params(rng, sizes) -> List[Dict[str, np.ndarray]]:
    return [_linear(rng, a, b) for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp(params, x, final_linear=True):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


def _pick(scores, idx=None):
    """argmax over the last axis of logits + gumbel, or the given picks."""
    return scores.argmax(-1) if idx is None else idx


class DreamerV3Config(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or DreamerV3)
        # model sizes (toy-scale defaults; the 8B-scale knobs are the same names)
        self.deter_size: int = 128
        self.stoch_classes: int = 8  # C
        self.stoch_groups: int = 8   # K -> z is K*C one-hots
        self.hidden: int = 128
        self.embed_size: int = 128
        # replay / training schedule
        self.replay_capacity: int = 100_000
        self.batch_size_seqs: int = 16
        self.seq_len: int = 16
        self.num_updates_per_iteration: int = 8
        self.sample_timesteps_per_iteration: int = 400
        self.num_steps_sampled_before_learning_starts: int = 1000
        # losses
        self.beta_pred: float = 1.0
        self.beta_dyn: float = 0.5
        self.beta_rep: float = 0.1
        self.free_bits: float = 1.0
        self.unimix: float = 0.01
        # imagination / actor-critic
        self.imag_horizon: int = 15
        self.gamma = 0.99
        self.lambda_: float = 0.95
        self.entropy_coef: float = 3e-3
        self.critic_ema_decay: float = 0.98
        self.retnorm_decay: float = 0.99
        self.lr_world: float = 4e-4
        self.lr_actor: float = 1e-4
        self.lr_critic: float = 1e-4
        self.grad_clip = 100.0

    def training(self, **kwargs) -> "DreamerV3Config":
        known = {k: kwargs.pop(k) for k in list(kwargs)
                 if hasattr(self, k) and k not in AlgorithmConfig.__dict__}
        for k, v in known.items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


# ----------------------------------------------------------------- model (pure)

class _DreamerNets:
    """Parameter builder (numpy, the JAX package's draws) and apply functions
    on a tree of tensors with the JAX package's keys."""

    def __init__(self, obs_dim: int, n_actions: int, cfg: DreamerV3Config):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.cfg = cfg
        self.z_size = cfg.stoch_groups * cfg.stoch_classes

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        d, h, e, z, a = (cfg.deter_size, cfg.hidden, cfg.embed_size,
                         self.z_size, self.n_actions)
        return {
            "enc": _mlp_params(rng, [self.obs_dim, h, e]),
            # GRU over x=[z, a_onehot] with state h
            "gru_r": _linear(rng, z + a + d, d),
            "gru_u": _linear(rng, z + a + d, d),
            "gru_c": _linear(rng, z + a + d, d),
            "prior": _mlp_params(rng, [d, h, z]),
            "post": _mlp_params(rng, [d + e, h, z]),
            "dec": _mlp_params(rng, [d + z, h, self.obs_dim]),
            "rew": _mlp_params(rng, [d + z, h, 1]),
            "cont": _mlp_params(rng, [d + z, h, 1]),
            "actor": _mlp_params(rng, [d + z, h, a]),
            "critic": _mlp_params(rng, [d + z, h, 1]),
        }

    # -- rssm -------------------------------------------------------------
    def gru(self, p, hstate, z, a_onehot):
        x = torch.cat([z, a_onehot], -1)
        xh = torch.cat([x, hstate], -1)
        r = torch.sigmoid(xh @ p["gru_r"]["w"] + p["gru_r"]["b"])
        u = torch.sigmoid(xh @ p["gru_u"]["w"] + p["gru_u"]["b"])
        xr = torch.cat([x, r * hstate], -1)
        c = torch.tanh(xr @ p["gru_c"]["w"] + p["gru_c"]["b"])
        return u * hstate + (1.0 - u) * c

    def _logits(self, raw):
        """[..., K*C] -> unimix'd log-probs [..., K, C]."""
        cfg = self.cfg
        lg = raw.reshape(*raw.shape[:-1], cfg.stoch_groups, cfg.stoch_classes)
        probs = torch.softmax(lg, -1)
        probs = (1 - cfg.unimix) * probs + cfg.unimix / cfg.stoch_classes
        return torch.log(probs)

    def sample_z(self, logp, gumbel, idx=None):
        """Straight-through one-hot sample from [..., K, C] log-probs ->
        ([..., K*C], the scores logp + gumbel that picked it)."""
        scores = logp + gumbel
        onehot = F.one_hot(_pick(scores, idx), self.cfg.stoch_classes).to(logp.dtype)
        probs = torch.exp(logp)
        st = onehot + probs - probs.detach()  # (onehot + probs) - sg(probs), as JAX orders it
        return st.reshape(*st.shape[:-2], self.z_size), scores

    def kl(self, logp_a, logp_b):
        """KL(a || b) over [..., K, C] log-probs, summed over groups."""
        return (torch.exp(logp_a) * (logp_a - logp_b)).sum(-1).sum(-1)

    # -- heads ------------------------------------------------------------
    def feat(self, hstate, z):
        return torch.cat([hstate, z], -1)

    def decode(self, p, f):
        return _mlp(p["dec"], f)

    def reward(self, p, f):
        return _mlp(p["rew"], f)[..., 0]  # symlog space

    def cont(self, p, f):
        return _mlp(p["cont"], f)[..., 0]  # logit

    def actor_logits(self, p, f):
        return _mlp(p["actor"], f)

    def value(self, p, f):
        return _mlp(p["critic"], f)[..., 0]  # symlog space


def gumbel(shape, generator, device):
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1), as
    jax.random.gumbel draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


# ------------------------------------------------------------------- replay

class _StreamBuffer:
    """Contiguous STATE stream with is_first markers (reference: Dreamer's
    episodic replay sampled as fixed-length windows). Numpy, copied as it is.

    Row t holds: obs_t, the action taken AT t, the reward received ENTERING t,
    and whether t is terminal. Terminal observations get their own row (with a
    dummy action that the next row's is_first masking neutralizes) — without
    them the continue head would never see a cont=0 target and imagination
    would never terminate."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int64)
        self.rew_in = np.zeros((capacity,), np.float32)
        self.terms = np.zeros((capacity,), np.float32)
        self.is_first = np.zeros((capacity,), np.float32)
        self.ptr = 0
        self.full = False

    def __len__(self):
        return self.capacity if self.full else self.ptr

    def _push(self, obs, action, rew_in, term, first) -> None:
        i = self.ptr
        self.obs[i] = obs
        self.actions[i] = action
        self.rew_in[i] = rew_in
        self.terms[i] = term
        self.is_first[i] = first
        self.ptr = (self.ptr + 1) % self.capacity
        if self.ptr == 0:
            self.full = True

    def add_episodes(self, episodes: List[Dict[str, np.ndarray]]) -> int:
        added = 0
        for ep in episodes:
            n = len(ep["actions"])
            for t in range(n):
                self._push(ep["obs"][t], ep["actions"][t],
                           ep["rewards"][t - 1] if t > 0 else 0.0,
                           0.0, 1.0 if t == 0 else 0.0)
                added += 1
            # ALWAYS write the final-state row (its dummy action is masked by
            # the next row's is_first): it carries the episode's LAST reward,
            # which would otherwise be censored for truncated/chunked episodes,
            # and the cont=0 target when the episode truly terminated
            self._push(ep["next_obs_last"], 0, ep["rewards"][n - 1],
                       1.0 if ep["terminated"] else 0.0, 0.0)
            added += 1
        return added

    def sample(self, batch: int, length: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        hi = len(self) - length
        starts = rng.integers(0, max(1, hi + 1), size=batch)
        # logical index 0 = OLDEST row (= ptr once the ring wrapped): windows
        # over logical positions are always time-contiguous, never splicing the
        # newest data onto the oldest across the write pointer
        base = self.ptr if self.full else 0
        idx = (base + starts[:, None] + np.arange(length)[None, :]) % self.capacity
        out = {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rew_in": self.rew_in[idx],
            "terms": self.terms[idx],
            "is_first": self.is_first[idx],  # fancy indexing already copies
        }
        out["is_first"][:, 0] = 1.0  # window start = state reset (no context)
        out["rew_in"][:, 0] = 0.0  # fresh context: no entering reward
        return out


# ------------------------------------------------------------------- learner

class DreamerV3Learner(Learner):
    """World model + actor + critic, each with its own optimizer (optax's
    clip_by_global_norm + adam, written out with train/optim.py), all on the
    learner's device (reference dreamerv3 torch_learner)."""

    def build(self) -> None:
        cfg = self.config
        obs_dim = int(np.prod(self.module.observation_space.shape))
        n_actions = int(self.module.action_space.n)
        self.nets = _DreamerNets(obs_dim, n_actions, cfg)
        self._set_params(self.nets.init_params(seed=cfg.seed or 0))
        self.critic_ema = params_from_numpy(to_numpy(self.params["critic"]), self.device)
        self.st_world = adamw_init(self._wm_leaves)
        self.st_actor = adamw_init(self._actor_leaves)
        self.st_critic = adamw_init(self._critic_leaves)
        # EMA of the 5th..95th percentile return range (actor normalization)
        self.ret_range = 1.0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed((cfg.seed or 0) + 7)
        self.metrics: Dict[str, Any] = {}

    def _set_params(self, tree) -> None:
        self.params = params_from_numpy(tree, self.device)
        self._wm_leaves = tree_leaves({k: self.params[k] for k in WM_KEYS})
        self._actor_leaves = tree_leaves(self.params["actor"])
        self._critic_leaves = tree_leaves(self.params["critic"])
        self._leaves = tree_leaves(self.params)
        for p in self._leaves:
            p.requires_grad_(True)

    def draw_noise(self, b: int, length: int) -> Dict[str, torch.Tensor]:
        """One update's Gumbel noise from the learner's generator: the world
        model's posterior draws [L, B, K, C], and imagination's action
        [H, N, A] and prior [H, N, K, C] draws, N = B * L starts."""
        cfg, nets = self.config, self.nets
        k, c, h, n = cfg.stoch_groups, cfg.stoch_classes, cfg.imag_horizon, b * length
        return {"wm": gumbel((length, b, k, c), self._gen, self.device),
                "act": gumbel((h, n, nets.n_actions), self._gen, self.device),
                "z": gumbel((h, n, k, c), self._gen, self.device)}

    # -- world model phase ------------------------------------------------
    def wm_loss(self, params, batch, noise, idx=None):
        """The world-model loss (JAX ``_build_wm_fn``'s wm_loss) on a batch of
        device tensors [B, L]; `noise` [L, B, K, C], `idx` optional picks
        [L, B, K]. Returns (loss, aux) with aux's ``starts_h``, ``starts_z``
        (detached) and ``z_scores`` [L, B, K, C] beside the metrics."""
        nets, cfg = self.nets, self.config
        b, length = batch["actions"].shape
        obs = _symlog(batch["obs"])
        embed = _mlp(params["enc"], obs)  # [B, L, E]
        a_onehot = F.one_hot(batch["actions"].long(), nets.n_actions).to(obs.dtype)
        # prev action for the sequence model, zeroed where an episode starts
        keep = (1.0 - batch["is_first"])[..., None]
        prev_a = torch.roll(a_onehot, 1, dims=1) * keep
        # per-state targets stored directly in the stream: reward entering
        # the state, and whether the state is terminal (cont = 1 - term)
        tgt_r = batch["rew_in"]
        tgt_cont = 1.0 - batch["terms"]

        hstate = obs.new_zeros((b, cfg.deter_size))
        z = obs.new_zeros((b, nets.z_size))
        hs, zs, posts, priors, scores = [], [], [], [], []
        for t in range(length):
            mask = (1.0 - batch["is_first"][:, t])[:, None]
            hstate = hstate * mask
            z = z * mask
            hstate = nets.gru(params, hstate, z, prev_a[:, t] * mask)
            post_lp = nets._logits(_mlp(params["post"], torch.cat([hstate, embed[:, t]], -1)))
            prior_lp = nets._logits(_mlp(params["prior"], hstate))
            z, s = nets.sample_z(post_lp, noise[t], None if idx is None else idx[t])
            hs.append(hstate)
            zs.append(z)
            posts.append(post_lp)
            priors.append(prior_lp)
            scores.append(s)
        hs = torch.stack(hs, 1)  # [B, L, D]
        zs = torch.stack(zs, 1)
        post_lp = torch.stack(posts, 1)
        prior_lp = torch.stack(priors, 1)
        f = nets.feat(hs, zs)

        recon = nets.decode(params, f)
        loss_rec = ((recon - obs) ** 2).sum(-1).mean()
        loss_rew = ((nets.reward(params, f) - _symlog(tgt_r)) ** 2).mean()
        cont_logit = nets.cont(params, f)
        # torch.maximum, like jnp.maximum, splits the gradient at a tie
        loss_cont = torch.mean(
            torch.maximum(cont_logit, cont_logit.new_zeros(())) - cont_logit * tgt_cont
            + torch.log1p(torch.exp(-torch.abs(cont_logit))))
        free_bits = post_lp.new_tensor(cfg.free_bits)
        kl_dyn = torch.maximum(free_bits, nets.kl(post_lp.detach(), prior_lp)).mean()
        kl_rep = torch.maximum(free_bits, nets.kl(post_lp, prior_lp.detach())).mean()
        loss = (cfg.beta_pred * (loss_rec + loss_rew + loss_cont)
                + cfg.beta_dyn * kl_dyn + cfg.beta_rep * kl_rep)
        aux = {"wm_loss": loss, "recon_loss": loss_rec, "reward_loss": loss_rew,
               "cont_loss": loss_cont, "kl_dyn": kl_dyn, "kl_rep": kl_rep,
               "starts_h": hs.reshape(-1, cfg.deter_size).detach(),
               "starts_z": zs.reshape(-1, nets.z_size).detach(),
               "z_scores": torch.stack(scores).detach()}
        return loss, aux

    # -- imagination + actor-critic phase ---------------------------------
    def imagine(self, params, actor_p, h0, z0, noise_a, noise_z, idx_a=None, idx_z=None):
        """H-step rollouts from [N] starts on the prior: each step's state,
        action, next state, and the scores that picked the action and z.
        Nothing in it carries a gradient (the actions are argmax picks)."""
        nets = self.nets
        out = {k: [] for k in ("hs", "zs", "acts", "h2s", "z2s", "a_scores", "z_scores")}
        hstate, z = h0, z0
        with torch.no_grad():
            for t in range(self.config.imag_horizon):
                f = nets.feat(hstate, z)
                a_scores = _mlp(actor_p, f) + noise_a[t]
                a = _pick(a_scores, None if idx_a is None else idx_a[t])
                a1 = F.one_hot(a, nets.n_actions).to(f.dtype)
                h2 = nets.gru(params, hstate, z, a1)
                z2, z_scores = nets.sample_z(nets._logits(_mlp(params["prior"], h2)), noise_z[t],
                                             None if idx_z is None else idx_z[t])
                for k, v in zip(out, (hstate, z, a, h2, z2, a_scores, z_scores)):
                    out[k].append(v)
                hstate, z = h2, z2
        return {k: torch.stack(v) for k, v in out.items()}  # [H, N, ...]

    def ac_losses(self, actor_p, critic_p, params, critic_ema, h0, z0, noise_a, noise_z,
                  ret_range, idx_a=None, idx_z=None):
        """The actor and critic losses (JAX ``_build_ac_fn``'s losses).
        Returns (actor_loss + critic_loss, aux) with the imagined actions'
        and states' scores beside the metrics."""
        nets, cfg = self.nets, self.config
        im = self.imagine(params, actor_p, h0, z0, noise_a, noise_z, idx_a, idx_z)
        f_next = nets.feat(im["h2s"], im["z2s"])  # state entered by each imagined action
        rew = _symexp(nets.reward(params, f_next))  # [H, N]
        cont = torch.sigmoid(nets.cont(params, f_next))
        v_next = _symexp(nets.value({"critic": critic_p}, f_next))
        # lambda-returns backwards over the horizon
        nxt = v_next[-1]
        rets = [None] * cfg.imag_horizon
        for t in reversed(range(cfg.imag_horizon)):
            nxt = rew[t] + cfg.gamma * cont[t] * ((1 - cfg.lambda_) * v_next[t]
                                                  + cfg.lambda_ * nxt)
            rets[t] = nxt
        rets = torch.stack(rets).detach()  # [H, N]
        f_cur = nets.feat(im["hs"], im["zs"])
        # discounted trajectory weights (stop after predicted termination)
        w = torch.cumprod(torch.cat(
            [torch.ones_like(cont[:1]), cfg.gamma * cont[:-1]], 0), 0).detach()
        # actor: REINFORCE with normalized advantage + entropy
        alogits = _mlp(actor_p, f_cur)
        logp_all = torch.log_softmax(alogits, -1)
        logp_a = torch.gather(logp_all, -1, im["acts"][..., None])[..., 0]
        v_cur = _symexp(nets.value({"critic": critic_p}, f_cur)).detach()
        adv = (rets - v_cur) / rets.new_tensor(max(1.0, float(np.float32(ret_range))))
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
        actor_loss = -(w * (logp_a * adv.detach() + cfg.entropy_coef * entropy)).mean()
        # critic: symlog regression to lambda-returns + EMA regularizer
        v_pred = nets.value({"critic": critic_p}, f_cur.detach())
        v_ema = nets.value({"critic": critic_ema}, f_cur.detach()).detach()
        critic_loss = (w * ((v_pred - _symlog(rets)) ** 2
                            + 0.3 * (v_pred - v_ema) ** 2)).mean()
        flat = rets.reshape(-1)
        aux = {"actor_loss": actor_loss, "critic_loss": critic_loss,
               "imag_return": rets.mean(), "actor_entropy": entropy.mean(),
               "ret_p95": torch.quantile(flat, 0.95), "ret_p5": torch.quantile(flat, 0.05),
               "a_scores": im["a_scores"], "z_scores": im["z_scores"]}
        return actor_loss + critic_loss, aux

    # -- the composite update ---------------------------------------------
    def _opt_step(self, grads, state: AdamWState, leaves, lr: float) -> AdamWState:
        grads = list(grads)
        clip_by_global_norm_(grads, self.config.grad_clip or 100.0)
        return adamw_update_(grads, state, leaves, learning_rate=lambda _: lr,
                             b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS, weight_decay=0.0)

    def _wm_grads(self, batch, noise, idx=None):
        with torch.enable_grad():
            loss, aux = self.wm_loss(self.params, batch, noise, idx)
            grads = torch.autograd.grad(loss, self._wm_leaves)
        return aux, grads

    def _ac_grads(self, h0, z0, noise, idx_a=None, idx_z=None):
        """Both gradients at the current actor and critic, on the world model
        as it stands (detached: the phase differentiates the actor and critic only)."""
        frozen = tree_map(lambda t: t.detach(), self.params)
        with torch.enable_grad():
            loss, aux = self.ac_losses(self.params["actor"], self.params["critic"], frozen,
                                       self.critic_ema, h0, z0, noise["act"], noise["z"],
                                       self.ret_range, idx_a, idx_z)
            grads = torch.autograd.grad(loss, self._actor_leaves + self._critic_leaves)
        n = len(self._actor_leaves)
        return aux, grads[:n], grads[n:]

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One world-model step, then imagination from its posterior states
        (computed before the step) on the stepped world model, the actor and
        critic steps, the critic's EMA, and ret_range on the host; the
        metrics and the two percentiles come back in one read."""
        cfg = self.config
        b, length = batch["actions"].shape
        on_dev = self._upload({k: batch[k] for k in ("obs", "actions", "rew_in", "terms",
                                                      "is_first")})
        noise = self.draw_noise(b, length)
        aux, wm_grads = self._wm_grads(on_dev, noise["wm"])
        self.st_world = self._opt_step(wm_grads, self.st_world, self._wm_leaves, cfg.lr_world)

        h0, z0 = aux.pop("starts_h"), aux.pop("starts_z")
        aux.pop("z_scores")
        ac_aux, g_actor, g_critic = self._ac_grads(h0, z0, noise)
        for k in ("a_scores", "z_scores"):
            ac_aux.pop(k)
        self.st_actor = self._opt_step(g_actor, self.st_actor, self._actor_leaves, cfg.lr_actor)
        self.st_critic = self._opt_step(g_critic, self.st_critic, self._critic_leaves,
                                        cfg.lr_critic)
        d = cfg.critic_ema_decay
        ema = tree_leaves(self.critic_ema)
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, self._critic_leaves, alpha=1 - d)
        names = [*aux, *ac_aux]
        host = torch.stack([*aux.values(), *ac_aux.values()]).detach().cpu().numpy()
        vals = dict(zip(names, host.tolist()))
        rng_now = vals.pop("ret_p95") - vals.pop("ret_p5")
        self.ret_range = (cfg.retnorm_decay * self.ret_range
                          + (1 - cfg.retnorm_decay) * rng_now)
        self.metrics = dict(vals)
        self.metrics["total_loss"] = self.metrics["wm_loss"]
        self.metrics["ret_range"] = float(self.ret_range)
        return self.metrics

    def get_weights(self):
        return to_numpy(self.params)

    def _opt_numpy(self, state: AdamWState, like) -> Dict[str, Any]:
        return {"count": np.int32(state.count),
                "mu": to_numpy(tree_unflatten(like, state.mu)),
                "nu": to_numpy(tree_unflatten(like, state.nu))}

    def _opt_from(self, opt) -> AdamWState:
        adam = opt if isinstance(opt, dict) else _adam_state(opt)
        if adam is None:
            raise ValueError("optimizer state holds no adam count, mu and nu")
        if not isinstance(adam, dict):
            adam = adam._asdict()
        return AdamWState(int(np.asarray(adam["count"])),
                          tree_leaves(params_from_numpy(adam["mu"], self.device)),
                          tree_leaves(params_from_numpy(adam["nu"], self.device)))

    def get_state(self) -> Dict[str, Any]:
        """Numpy trees: params, critic_ema, and each optimizer's adam count,
        mu and nu (the leaves of optax's ScaleByAdamState); ret_range."""
        wm = {k: self.params[k] for k in WM_KEYS}
        return {"params": to_numpy(self.params), "critic_ema": to_numpy(self.critic_ema),
                "st_world": self._opt_numpy(self.st_world, wm),
                "st_actor": self._opt_numpy(self.st_actor, self.params["actor"]),
                "st_critic": self._opt_numpy(self.st_critic, self.params["critic"]),
                "ret_range": float(self.ret_range)}

    def set_state(self, state: Dict[str, Any]) -> None:
        """Takes get_state's form or the JAX learner's (optax chain states)."""
        self._set_params(state["params"])
        if state.get("critic_ema") is not None:
            self.critic_ema = params_from_numpy(state["critic_ema"], self.device)
        for k in ("st_world", "st_actor", "st_critic"):
            if state.get(k) is not None:
                setattr(self, k, self._opt_from(state[k]))
        self.ret_range = float(state.get("ret_range", self.ret_range))


# ------------------------------------------------------------------- env runner

def _np_mlp(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = np.tanh(x)
    return x


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class DreamerV3EnvRunner:
    """Recurrent rollout worker: carries (h, z, prev_action) per env and resets
    them on episode boundaries (reference dreamerv3/utils/env_runner.py). It
    acts on the host in numpy (``act_np``), with Gumbel noise from its own
    ``np.random.Generator``."""

    def __init__(self, config: DreamerV3Config, worker_index: int = 0):
        self.config = config
        self.worker_index = worker_index
        self.num_envs = config.num_envs_per_env_runner
        maker = config.env_maker()
        if isinstance(config.env, type) and hasattr(config.env, "make_vec"):
            self.env = config.env.make_vec(self.num_envs, dict(config.env_config))
        else:
            gym = import_gymnasium(f"stepping {config.env!r} without make_vec")
            self.env = gym.vector.SyncVectorEnv([maker for _ in range(self.num_envs)])
        single = maker()
        obs_dim = int(np.prod(single.observation_space.shape))
        self.nets = _DreamerNets(obs_dim, int(single.action_space.n), config)
        single.close()
        self.params = self.nets.init_params(seed=config.seed or 0)
        self.rng = np.random.default_rng((config.seed or 0) + worker_index + 1)
        self._obs = None
        self.metrics: Dict[str, Any] = {}

    def act_np(self, params, hstate, z, prev_a, obs, first, gumbel_z, gumbel_a, explore):
        """One step of the recurrent policy for [n] envs (JAX ``act``): the
        GRU, the posterior draw of z with `gumbel_z` [n, K, C], and the action,
        argmax of logits + `gumbel_a` [n, A] when exploring, else argmax."""
        nets, cfg = self.nets, self.config
        mask = (1.0 - first)[:, None]
        hstate = hstate * mask
        z = z * mask
        prev_a = prev_a * mask
        x = np.concatenate([z, prev_a], -1)
        xh = np.concatenate([x, hstate], -1)
        r = _np_sigmoid(xh @ params["gru_r"]["w"] + params["gru_r"]["b"])
        u = _np_sigmoid(xh @ params["gru_u"]["w"] + params["gru_u"]["b"])
        c = np.tanh(np.concatenate([x, r * hstate], -1) @ params["gru_c"]["w"]
                    + params["gru_c"]["b"])
        hstate = u * hstate + (1.0 - u) * c
        embed = _np_mlp(params["enc"], np.sign(obs) * np.log1p(np.abs(obs)))
        raw = _np_mlp(params["post"], np.concatenate([hstate, embed], -1))
        lg = raw.reshape(len(raw), cfg.stoch_groups, cfg.stoch_classes)
        e = np.exp(lg - lg.max(-1, keepdims=True))
        probs = (1 - cfg.unimix) * (e / e.sum(-1, keepdims=True)) + cfg.unimix / cfg.stoch_classes
        logp = np.log(probs.astype(np.float32))
        onehot = np.eye(cfg.stoch_classes, dtype=np.float32)[np.argmax(logp + gumbel_z, -1)]
        probs = np.exp(logp)
        z = ((onehot + probs) - probs).reshape(len(raw), nets.z_size)
        logits = _np_mlp(params["actor"], np.concatenate([hstate, z], -1))
        a = np.argmax(logits + gumbel_a, -1) if explore else np.argmax(logits, -1)
        return hstate, z, a

    # -- weights / control --------------------------------------------------
    def get_state(self):
        return {"params": self.params}

    def set_state(self, state):
        self.params = state["params"]

    def set_weights(self, params):
        self.params = params

    def get_metrics(self):
        return self.metrics

    def stop(self) -> None:
        self.env.close()

    # -- sampling -----------------------------------------------------------
    def _reset_if_needed(self):
        if self._obs is None:
            obs, _ = self.env.reset(seed=(self.config.seed or 0) + self.worker_index)
            self._obs = obs
            n = self.num_envs
            self._episodes = [SingleAgentEpisode() for _ in range(n)]
            for i in range(n):
                self._episodes[i].add_env_reset(obs[i])
            self._prev_done = np.zeros(n, dtype=bool)
            self._first = np.ones(n, np.float32)
            self._h = np.zeros((n, self.config.deter_size), np.float32)
            self._z = np.zeros((n, self.nets.z_size), np.float32)
            self._pa = np.zeros((n, self.nets.n_actions), np.float32)

    def sample(self, num_timesteps: Optional[int] = None, explore: bool = True):
        cfg = self.config
        num_timesteps = num_timesteps or cfg.rollout_fragment_length * self.num_envs
        self._reset_if_needed()
        n, k, c = self.num_envs, cfg.stoch_groups, cfg.stoch_classes
        done_eps = []
        returns: List[float] = []
        steps = 0
        while steps < num_timesteps:
            g_z = self.rng.gumbel(size=(n, k, c)).astype(np.float32)
            g_a = self.rng.gumbel(size=(n, self.nets.n_actions)).astype(np.float32)
            self._h, self._z, actions = self.act_np(
                self.params, self._h, self._z, self._pa, np.asarray(self._obs, np.float32),
                self._first, g_z, g_a, explore)
            self._pa = np.eye(self.nets.n_actions, dtype=np.float32)[actions]
            self._first = np.zeros(self.num_envs, np.float32)
            obs, rewards, terms, truncs, _ = self.env.step(actions)
            for i in range(self.num_envs):
                if self._prev_done[i]:
                    self._episodes[i] = SingleAgentEpisode()
                    self._episodes[i].add_env_reset(obs[i])
                    self._prev_done[i] = False
                    self._first[i] = 1.0
                    continue
                ep = self._episodes[i]
                ep.add_env_step(obs[i], actions[i], rewards[i], terms[i], truncs[i])
                steps += 1
                if terms[i] or truncs[i]:
                    returns.append(ep.get_return())
                    done_eps.append(ep)
                    self._prev_done[i] = True
                    self._first[i] = 1.0
            self._obs = obs
        for i in range(self.num_envs):
            if not self._prev_done[i] and len(self._episodes[i]):
                done_eps.append(self._episodes[i])
                self._episodes[i] = SingleAgentEpisode()
                self._episodes[i].add_env_reset(self._obs[i])
        self.metrics = {
            "num_env_steps_sampled": steps,
            "episode_return_mean": float(np.mean(returns)) if returns else None,
            "num_episodes": len(returns),
        }
        return [ep.to_numpy() for ep in done_eps]


# ------------------------------------------------------------------- algorithm

class DreamerV3(Algorithm):
    learner_class = DreamerV3Learner
    env_runner_cls = DreamerV3EnvRunner  # recurrent rollout workers

    @classmethod
    def get_default_config(cls) -> DreamerV3Config:
        return DreamerV3Config(cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self._algo_config
        obs_dim = int(np.prod(self.module_spec.observation_space.shape))
        self.buffer = _StreamBuffer(cfg.replay_capacity, obs_dim)
        self._np_rng = np.random.default_rng(cfg.seed or 0)
        self._env_steps = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        episodes = self.env_runner_group.sample(cfg.sample_timesteps_per_iteration)
        self.buffer.add_episodes(episodes)
        self._env_steps += sum(len(ep["actions"]) for ep in episodes)
        for m in self.env_runner_group.get_metrics():
            self.metrics.log_dict({k: v for k, v in m.items() if v is not None},
                                  window=20)
        warm = (len(self.buffer)
                >= max(cfg.num_steps_sampled_before_learning_starts,
                       cfg.seq_len * 2))
        if warm:
            for _ in range(cfg.num_updates_per_iteration):
                batch = self.buffer.sample(cfg.batch_size_seqs, cfg.seq_len,
                                           self._np_rng)
                for lm in self.learner_group.update(batch):
                    self.metrics.log_dict(lm)
            self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self.metrics.reduce()
        result["num_env_steps_sampled_lifetime"] = self._env_steps
        return result
