"""IMPALA: importance-weighted actor-learner architecture with V-trace
(port of ray_tpu/rllib/algorithms/impala.py).

Capability parity: reference rllib/algorithms/impala/impala.py:142 — sampling
that runs one policy version behind the learner, episode chunks padded into
fixed-shape time-major batches, the V-trace off-policy correction (Espeholt et
al. 2018) in a policy-gradient, value and entropy loss, and a weight
broadcast every ``broadcast_interval`` updates.

The learner runs on the card unless the config asks for the CPU. One update
uploads the padded batch once and takes ``num_epochs`` whole-batch steps;
the V-trace recursion is a reverse loop over the T steps of [B]-wide tensor
ops (``utils/gae.py``), run on detached tensors: the JAX package's
stop_gradients leave the gradient only the paths through the target
log-probabilities and the values.

The JAX package samples its runners as actors and keeps one sample of each
in flight: a runner's next sample is issued as soon as its last one is
taken, before the update and the weight sync, so the learner trains on data
the policy of one version before collected, and V-trace corrects for the
lag. The port holds its runners in process and keeps that lag: ``_issue``
samples a runner at once and holds the episodes as in flight, and
``training_step`` takes them in runner order (the JAX package takes
whichever finished first) and re-issues each runner right after taking its
result. A runner's exception propagates. Not ported yet, each naming its
ROADMAP item: aggregator actors (``num_aggregator_actors_per_learner > 0``)
and the restart of a failed runner, which need a hosting runtime (A9b).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.learner import Learner
from ..core.rl_module import Columns
from ..utils.gae import vtrace_scan
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or IMPALA)
        self.vtrace_clip_rho_threshold: float = 1.0
        self.vtrace_clip_pg_rho_threshold: float = 1.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.005
        self.broadcast_interval: int = 1  # learner updates between weight broadcasts
        self.num_aggregator_actors_per_learner: int = 0
        self.max_seq_len: int = 64  # pad/split episode chunks to this length
        self.num_epochs = 1  # IMPALA is single-pass
        self.minibatch_size = None

    def training(self, *, vtrace_clip_rho_threshold=None, vtrace_clip_pg_rho_threshold=None,
                 vf_loss_coeff=None, entropy_coeff=None, broadcast_interval=None,
                 num_aggregator_actors_per_learner=None, max_seq_len=None, **kwargs):
        for k, v in dict(
            vtrace_clip_rho_threshold=vtrace_clip_rho_threshold,
            vtrace_clip_pg_rho_threshold=vtrace_clip_pg_rho_threshold,
            vf_loss_coeff=vf_loss_coeff, entropy_coeff=entropy_coeff,
            broadcast_interval=broadcast_interval,
            num_aggregator_actors_per_learner=num_aggregator_actors_per_learner,
            max_seq_len=max_seq_len,
        ).items():
            if v is not None:
                setattr(self, k, v)
        super().training(**kwargs)
        return self


def _split_episode(ep: Dict[str, np.ndarray], max_T: int) -> List[Dict[str, np.ndarray]]:
    """Split an episode chunk into <=max_T pieces; interior pieces bootstrap."""
    T = len(ep["rewards"])
    if T <= max_T:
        return [ep]
    out = []
    for s in range(0, T, max_T):
        e = s + min(max_T, T - s)
        last = e == T
        piece = {
            "obs": ep["obs"][s:e],
            # boundary obs: next chunk's first obs doubles as this chunk's bootstrap obs
            "next_obs_last": ep["next_obs_last"] if last else ep["obs"][e],
            "actions": ep["actions"][s:e],
            "rewards": ep["rewards"][s:e],
            "terminated": ep["terminated"] and last,
            "truncated": ep["truncated"] and last,
        }
        for k in (Columns.ACTION_LOGP, Columns.VF_PREDS):
            if k in ep:
                piece[k] = ep[k][s:e]
        out.append(piece)
    return out


def pad_time_major(episodes: List[Dict[str, np.ndarray]], max_T: int,
                   b_bucket: int = 8) -> Dict[str, np.ndarray]:
    """Pad episode chunks into fixed-shape numpy arrays, bit-equal to the JAX
    package's.

    Returns batch-major arrays: obs_ext [B, T+1, D] f32 (row `lens[b]` holds
    the bootstrap obs), actions [B, T, ...] in the episodes' dtype, behaviour
    logp / rewards / mask [B, T] f32, lens [B] int32 and terminated [B] f32.
    B is rounded up to a multiple of `b_bucket` with mask-zero rows.
    """
    pieces: List[Dict[str, np.ndarray]] = []
    for ep in episodes:
        pieces.extend(_split_episode(ep, max_T))
    B = len(pieces)
    Bp = ((B + b_bucket - 1) // b_bucket) * b_bucket
    obs_dim = int(np.prod(pieces[0]["obs"].shape[1:]))
    act_shape = pieces[0]["actions"].shape[1:]
    obs_ext = np.zeros((Bp, max_T + 1, obs_dim), np.float32)
    actions = np.zeros((Bp, max_T) + act_shape, pieces[0]["actions"].dtype)
    logp = np.zeros((Bp, max_T), np.float32)
    rewards = np.zeros((Bp, max_T), np.float32)
    mask = np.zeros((Bp, max_T), np.float32)
    lens = np.zeros(Bp, np.int32)
    terminated = np.zeros(Bp, np.float32)
    for b, p in enumerate(pieces):
        T = len(p["rewards"])
        obs_ext[b, :T] = p["obs"].reshape(T, -1)
        obs_ext[b, T] = np.asarray(p["next_obs_last"]).reshape(-1)
        actions[b, :T] = p["actions"]
        logp[b, :T] = np.asarray(p[Columns.ACTION_LOGP], np.float32)
        rewards[b, :T] = p["rewards"]
        mask[b, :T] = 1.0
        lens[b] = T
        terminated[b] = float(bool(p["terminated"]))
    return {
        "obs_ext": obs_ext, "actions": actions, "behaviour_logp": logp,
        "rewards": rewards, "mask": mask, "lens": lens, "terminated": terminated,
    }


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    """x[:, t + 1] at t, 0 at the last step."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


class IMPALALearner(Learner):
    """V-trace actor-critic loss, whole-batch steps on one padded batch."""

    def compute_losses(self, params, batch):
        cfg = self.config
        B, Tp1, D = batch["obs_ext"].shape
        T = Tp1 - 1
        out = self.module.forward_train(params, {Columns.OBS: batch["obs_ext"].reshape(B * Tp1, D)})
        dist = self.module.action_dist_cls
        logits = out[Columns.ACTION_DIST_INPUTS].reshape(B, Tp1, -1)
        values_ext = out[Columns.VF_PREDS].reshape(B, Tp1)
        mask = batch["mask"]
        values = values_ext[:, :T] * mask

        step_logits = logits[:, :T].reshape(B * T, -1)
        actions = batch["actions"]
        step_actions = actions.reshape((B * T,) + tuple(actions.shape[2:]))
        target_logp = dist.logp_torch(step_logits, step_actions).reshape(B, T) * mask
        entropy = dist.entropy_torch(step_logits).reshape(B, T)
        behaviour_logp = batch["behaviour_logp"] * mask

        # V-trace reaches the loss only through stop_gradient (the JAX
        # learner's pg_adv and vs): the recursion runs on detached tensors
        with torch.no_grad():
            # the bootstrap value lives at row lens[b] of the extended
            # sequence; a padded row (lens 0) reads row 0 and is masked
            lens = batch["lens"].long()
            term = batch["terminated"]
            bootstrap = values_ext.gather(1, lens[:, None])[:, 0] * (1.0 - term)
            v = values.detach()
            rhos = torch.exp(target_logp.detach() - behaviour_logp)
            clipped_rho = torch.clamp(rhos, max=cfg.vtrace_clip_rho_threshold) * mask
            cs = torch.clamp(rhos, max=1.0) * mask
            # a terminated piece's last step gets discount 0; a truncated one
            # bootstraps; padded steps contribute nothing
            steps = torch.arange(T, device=mask.device)
            is_last = (steps[None, :] == (lens - 1)[:, None]).float()
            discounts = cfg.gamma * (1.0 - is_last * term[:, None]) * mask
            # at t = len-1 the next value is the bootstrap, not values[t+1]
            boot_last = is_last * bootstrap[:, None]
            v_tp1 = _shift_left(v) + boot_last
            deltas = clipped_rho * (batch["rewards"] + discounts * v_tp1 - v)
            vs = v + vtrace_scan(deltas.T, discounts.T, cs.T).T
            vs_tp1 = _shift_left(vs) + boot_last
            clipped_pg_rho = torch.clamp(rhos, max=cfg.vtrace_clip_pg_rho_threshold) * mask
            pg_adv = clipped_pg_rho * (batch["rewards"] + discounts * vs_tp1 - v)

        n = torch.clamp(mask.sum(), min=1.0)
        mean_kl = ((behaviour_logp - target_logp) * mask).sum() / n
        pg_loss = self._pg_loss(target_logp, behaviour_logp, pg_adv, mask, n,
                                batch.get("kl_coeff", 0.0))
        vf_loss = 0.5 * (torch.square(vs - values) * mask).sum() / n
        ent = (entropy * mask).sum() / n
        total = pg_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * ent
        return total, {
            "policy_loss": pg_loss, "vf_loss": vf_loss, "entropy": ent,
            "mean_rho": (rhos * mask).sum() / n, "mean_kl": mean_kl,
        }

    def _pg_loss(self, target_logp, behaviour_logp, pg_adv, mask, n, kl_coeff):
        """Vanilla importance-weighted policy gradient (APPO overrides with a clip)."""
        return -(target_logp * pg_adv).sum() / n

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Whole-batch steps on one padded batch, uploaded once; the extra
        epochs are off-policy-corrected by V-trace (rhos grow as the policy
        drifts). The metrics are the last epoch's, read back once."""
        on_dev = self._upload(batch)
        for _ in range(max(1, self.config.num_epochs)):
            loss, aux = self._step(on_dev)
        host = torch.stack([loss, *aux.values()]).cpu().numpy()
        self.metrics = {"total_loss": float(host[0]),
                        **{k: float(v) for k, v in zip(aux, host[1:])}}
        return self.metrics


class IMPALA(Algorithm):
    learner_class = IMPALALearner

    @classmethod
    def get_default_config(cls) -> IMPALAConfig:
        return IMPALAConfig(cls)

    def setup(self, _config) -> None:
        if self._algo_config.num_aggregator_actors_per_learner > 0:
            raise NotImplementedError(
                "aggregator actors (num_aggregator_actors_per_learner > 0) need a hosting "
                "runtime, which is not ported yet (ROADMAP A9b)")
        super().setup(_config)
        # runner index -> the episodes of its sample in flight, oldest first
        self._inflight: Dict[int, List[Dict[str, np.ndarray]]] = {}
        self._updates_since_broadcast = 0

    def _issue(self, idx: int) -> None:
        group = self.env_runner_group
        per = max(1, self._algo_config.train_batch_size // group.n)
        self._inflight[idx] = group.runners[idx].sample(per, True)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        group = self.env_runner_group
        if not self._inflight:
            for i in range(group.n):
                self._issue(i)
        # take the oldest sample in flight and re-issue its runner at once,
        # with the weights it has now: the next update trains on data one
        # policy version old
        episodes: List[Dict[str, np.ndarray]] = []
        steps = 0
        while steps < cfg.train_batch_size:
            idx = next(iter(self._inflight))
            eps = self._inflight.pop(idx)
            episodes.extend(eps)
            steps += sum(len(e["rewards"]) for e in eps)
            self._issue(idx)
        if not episodes:
            return self.metrics.reduce()
        for m in group.get_metrics():
            self.metrics.log_dict({k: v for k, v in m.items() if v is not None}, window=20)
        batch = pad_time_major(episodes, cfg.max_seq_len)
        learner_metrics = self.learner_group.update(batch)
        for lm in learner_metrics:
            self.metrics.log_dict(lm)
        self._updates_since_broadcast += 1
        if self._updates_since_broadcast >= cfg.broadcast_interval:
            group.sync_weights(self.learner_group.get_weights())
            self._updates_since_broadcast = 0
        result = self.metrics.reduce()
        result["num_env_steps_trained"] = steps
        return result

    def cleanup(self) -> None:
        self._inflight.clear()
        super().cleanup()

    stop = cleanup
