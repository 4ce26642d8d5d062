"""Parity of the port's off-policy and offline RLlib slice (ray_tpu_torch/rllib:
DQN, SAC, CQL, MARWIL / BC, replay, offline data) with the JAX package.

The same numpy inputs, seeds, weights and noise go through both packages on
the CPU: the replay buffers, the offline batches, the numpy distribution
samples, the runners' episodes and chip_smoke's env copies bit for bit; the
distributions and the modules within 1e-6; one update of each learner within
1e-5 of max|ref| per leaf (targets included); two DQN.train() iterations
against the same iterations composed from the JAX package's classes within
1e-4. The JAX losses draw their noise from jax.random; the tests draw it from
the same key splits and hand it to the port's learner (``draw_noise``). The
JAX results are computed once per module.
"""
import json
import sys

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_util import one_torch_thread  # noqa: F401
from ray_tpu.rllib import offline as jax_offline
from ray_tpu.rllib.algorithms.cql import CQLConfig as JaxCQLConfig
from ray_tpu.rllib.algorithms.cql import CQLLearner as JaxCQLLearner
from ray_tpu.rllib.algorithms.dqn import DQNConfig as JaxDQNConfig
from ray_tpu.rllib.algorithms.dqn import DQNLearner as JaxDQNLearner
from ray_tpu.rllib.algorithms.marwil import MARWILConfig as JaxMARWILConfig
from ray_tpu.rllib.algorithms.marwil import MARWILLearner as JaxMARWILLearner
from ray_tpu.rllib.algorithms.sac import SACConfig as JaxSACConfig
from ray_tpu.rllib.algorithms.sac import SACLearner as JaxSACLearner
from ray_tpu.rllib.core import distributions as jax_dist
from ray_tpu.rllib.core import rl_module as jax_module
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JaxRunner
from ray_tpu.rllib.utils import replay_buffer as jax_replay
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib import offline as pt_offline
from ray_tpu_torch.rllib.core import distributions as pt_dist
from ray_tpu_torch.rllib.core import rl_module as pt_module
from ray_tpu_torch.rllib.core.learner import _adam_state
from ray_tpu_torch.rllib.utils import replay_buffer as pt_replay

FWD_TOL = 1e-6  # distributions, module forwards: f32, another op order
UPDATE_TOL = 1e-5  # one update: per leaf, of max|ref|; and the loss metrics
# two or more optimizer steps (two DQN iterations; an update after a state
# move): per leaf, of max|ref|. adam's second step divides a first moment
# that may nearly cancel by sqrt(nu), which lifts the forward's 1e-7
SLICE_TOL = 1e-4
HIDDENS = [32, 32]
LEARNER_HIDDENS = [16]  # one hidden layer: each JAX learner compiles in about half the time
B = 16  # the learners' batch
OBS_SPACE = gym.spaces.Box(-1.0, 1.0, (5,), np.float32)
DISCRETE = gym.spaces.Discrete(4)
BOX = gym.spaces.Box(np.array([-1.0, -2.0], np.float32), np.array([1.0, 0.5], np.float32))


def _assert_tree_close(got, want, tol, where):
    got_l, want_l = pt_module.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), where
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (where, i)
        err = float(np.max(np.abs(g - w)))
        assert err <= tol * float(np.max(np.abs(w))), (where, i, err)


def _assert_tree_equal(got, want, where):
    got_l, want_l = pt_module.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), where
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=where)


def _assert_metrics_close(got, want, tol=UPDATE_TOL):
    keys = [k for k in want if not k.startswith("_")]
    assert sorted(k for k in got if not k.startswith("_")) == sorted(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


def _batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_opt_state(jax_learner, state):
    """The port's numpy optimizer state as the JAX learner's optax tree."""
    opt = state["opt_state"]
    leaves = [opt["count"], *pt_module.tree_leaves(opt["mu"]),
              *pt_module.tree_leaves(opt["nu"])]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jax_learner.opt_state),
                                        leaves)


# ---- replay buffers --------------------------------------------------------------

def _episodes(seed, obs_dtype=np.float32, continuous=False):
    """Episodes of 7, 1, 12 (terminated, truncated, terminated) and an empty one."""
    rng = np.random.default_rng(seed)
    out = []
    for t, term in ((7, True), (1, False), (12, True), (0, False)):
        obs = (rng.integers(0, 255, (t + 1, 3)) if obs_dtype == np.uint8
               else rng.standard_normal((t + 1, 3))).astype(obs_dtype)
        actions = (rng.uniform(-1, 1, (t, 2)).astype(np.float32) if continuous
                   else rng.integers(0, 4, t).astype(np.int32))
        out.append({"obs": obs[:-1], "next_obs_last": obs[-1], "actions": actions,
                    "rewards": rng.standard_normal(t).astype(np.float32),
                    "terminated": term, "truncated": not term})
    return out


@pytest.mark.parametrize("kind,n_step,obs_dtype,continuous", [
    ("uniform", 1, np.float32, False), ("uniform", 3, np.uint8, False),
    ("uniform", 1, np.float32, True), ("prioritized", 1, np.float32, False),
    ("prioritized", 3, np.float32, True)])
def test_replay_buffers_are_bit_equal(kind, n_step, obs_dtype, continuous):
    """Two rounds of episodes into a 16-row ring (it wraps), storage and
    samples bit-equal with the same default_rng; prioritized: the IS
    weights, batch_indexes and update_priorities too. uint8 frames stay uint8."""
    cls = {"uniform": "ReplayBuffer", "prioritized": "PrioritizedReplayBuffer"}[kind]
    bufs = [getattr(m, cls)(16, n_step=n_step, gamma=0.9) for m in (jax_replay, pt_replay)]
    rngs = [np.random.default_rng(3), np.random.default_rng(3)]
    for seed in (0, 1):
        eps = _episodes(seed, obs_dtype, continuous)
        assert bufs[1].add_episodes(eps) == bufs[0].add_episodes(eps)
        assert len(bufs[1]) == len(bufs[0]) and bufs[1]._idx == bufs[0]._idx
        _batches_equal(bufs[1]._storage, bufs[0]._storage)
        want, got = (b.sample(8, r) for b, r in zip(bufs, rngs))
        _batches_equal(got, want)
        if kind == "prioritized":
            td = np.random.default_rng(seed).standard_normal(8).astype(np.float32) * 3
            for b, s in zip(bufs, (want, got)):
                b.update_priorities(s["batch_indexes"], td)
            np.testing.assert_array_equal(bufs[1]._priorities, bufs[0]._priorities)
            assert bufs[1]._max_priority == bufs[0]._max_priority
    assert bufs[1]._storage["obs"].dtype == obs_dtype
    assert len(bufs[1]) == 16  # 40 rows through a ring of 16


# ---- distributions and modules ------------------------------------------------------

def _squashed_inputs(rng, b=32):
    mu = rng.standard_normal((b, 2)).astype(np.float32)
    log_std = rng.uniform(-25, 3, (b, 2)).astype(np.float32)  # beyond both clips
    low, high = np.broadcast_to(BOX.low, (b, 2)), np.broadcast_to(BOX.high, (b, 2))
    return np.concatenate([mu, log_std, low, high], axis=1).astype(np.float32)


@pytest.mark.parametrize("name", ["SquashedGaussian", "EpsilonGreedyQ"])
def test_distribution_matches_jax(name):
    rng = np.random.default_rng(4)
    if name == "SquashedGaussian":
        inputs = _squashed_inputs(rng)
        actions = rng.uniform(BOX.low, BOX.high, (32, 2)).astype(np.float32)
        actions[0] = BOX.low  # the bounds: the clip to the open interval
        actions[1] = BOX.high
    else:
        q = rng.standard_normal((32, 4)).astype(np.float32)
        q[:5, 1] = q[:5, 0] = q[:5].max(axis=1) + 1  # tied maxima: the first wins
        inputs = np.concatenate([q, np.full((32, 1), 0.3, np.float32)], axis=1)
        actions = rng.integers(0, 4, 32)
    pt_cls, jax_cls = getattr(pt_dist, name), getattr(jax_dist, name)
    x, a = torch.from_numpy(inputs), torch.from_numpy(actions)
    for got, want in ((pt_cls.logp_torch(x, a), jax_cls.logp_jax(jnp.asarray(inputs),
                                                                 jnp.asarray(actions))),
                      (pt_cls.entropy_torch(x), jax_cls.entropy_jax(jnp.asarray(inputs)))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_array_equal(pt_cls.logp_np(inputs, actions), jax_cls.logp_np(inputs, actions))
    np.testing.assert_array_equal(pt_cls.sample_np(inputs, np.random.default_rng(1)),
                                  jax_cls.sample_np(inputs, np.random.default_rng(1)))
    np.testing.assert_array_equal(pt_cls.greedy_np(inputs), jax_cls.greedy_np(inputs))
    if name == "EpsilonGreedyQ":
        assert (pt_cls.greedy_np(inputs)[:5] == 0).all()


def test_squashed_logp_constants_match_jax():
    for k in ("LOG_STD_MIN", "LOG_STD_MAX", "TANH_CLIP", "SQUASH_EPS"):
        assert getattr(pt_dist, k) == getattr(jax_dist, k), k


def _module_pair(kind, hiddens=HIDDENS):
    act = DISCRETE if kind == "dqn" else BOX
    cls = {"dqn": "DQNModule", "sac": "SACModule"}[kind]
    cfg = {"fcnet_hiddens": hiddens}
    return (getattr(jax_module, cls)(OBS_SPACE, act, cfg),
            getattr(pt_module, cls)(OBS_SPACE, act, cfg))


@pytest.mark.parametrize("kind", ["dqn", "sac"])
def test_module_forwards_match_jax(kind):
    """init_params and apply_np bit-equal; apply_torch, q_values / pi / q and
    sample_action with JAX's normal draws handed in, within 1e-6."""
    jax_mod, pt_mod = _module_pair(kind)
    params = jax_mod.init_params(seed=5)
    _assert_tree_equal(pt_mod.init_params(seed=5), params, "init_params")
    params["epsilon" if kind == "dqn" else "log_alpha"] = np.float32(0.25)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = pt_module.params_from_numpy(params, "cpu")
    obs = np.random.default_rng(0).standard_normal((16, 5)).astype(np.float32)
    jobs, tobs = jnp.asarray(obs), torch.from_numpy(obs)

    def close(got, want, what):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=what)

    for k in (rllib.Columns.ACTION_DIST_INPUTS, rllib.Columns.VF_PREDS):
        np.testing.assert_array_equal(pt_mod.apply_np(params, obs)[k], jax_mod.apply_np(params, obs)[k])
        close(pt_mod.apply_torch(tparams, tobs)[k], jax_mod.apply_jax(jparams, jobs)[k], k)
    if kind == "dqn":
        np.testing.assert_array_equal(pt_mod.q_values_np(params, obs), jax_mod.q_values_np(params, obs))
        close(pt_mod.q_values_torch(tparams, tobs), jax_mod.q_values_jax(jparams, jobs), "q")
        return
    for got, want in zip(pt_mod.pi_torch(tparams, tobs), jax_mod.pi_jax(jparams, jobs)):
        close(got, want, "pi")
    key = jax.random.PRNGKey(7)
    want_a, want_lp = jax_mod.sample_action_jax(jparams, jobs, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (16, 2))))
    got_a, got_lp = pt_mod.sample_action_torch(tparams, tobs, noise)
    close(got_a, want_a, "action")
    # log(1 - t^2) turns one ulp of t = tanh(u), where the two libraries'
    # f32 tanh may differ, into 2|t| ulp(t) / (1 - t^2): near saturation
    # (|u| ~ 4 and more, as some rows here) that is the log-density's error
    mu, log_std = (x.detach().numpy() for x in pt_mod.pi_torch(tparams, tobs))
    u = mu + np.exp(log_std) * noise.numpy()
    t = np.abs(np.tanh(u))
    ulp_cost = (2 * t * np.spacing(t) / (1 - t**2)).sum(-1)
    want_lp = np.asarray(want_lp)
    err = np.abs(got_lp.detach().numpy() - want_lp)
    assert (err <= FWD_TOL * (1 + np.abs(want_lp)) + 4 * ulp_cost).all(), (err, ulp_cost)
    inputs = (u, np.tanh(u), mu, log_std, BOX.low, BOX.high)  # the formula on one (u, t)
    np.testing.assert_allclose(
        pt_dist.squashed_logp_from_u_torch(*map(torch.from_numpy, inputs)).numpy(),
        np.asarray(jax_dist.squashed_logp_from_u_jax(*map(jnp.asarray, inputs))),
        rtol=FWD_TOL, atol=FWD_TOL)
    for which in ("q1", "q2"):
        close(pt_mod.q_torch(tparams, which, tobs, got_a),
              jax_mod.q_jax(jparams, which, jobs, want_a), which)


class _Space:
    def __init__(self, shape=None, n=None, low=None, high=None):
        self.shape = shape
        if n is not None:
            self.n = n
        if low is not None:
            self.low, self.high = low, high


@pytest.mark.parametrize("cls,space,match", [
    ("SACModule", _Space(n=3), "Box action space"),
    ("SACModule", _Space(shape=(2,)), "Box action space"),
    ("SACModule", _Space((1,), low=np.array([-np.inf]), high=np.array([1.0])), "finite"),
    ("DQNModule", _Space((1,), low=np.array([-1.0]), high=np.array([1.0])), "Discrete")])
def test_modules_refuse_the_wrong_space_without_gymnasium(cls, space, match):
    with pytest.raises(ValueError, match=match):
        getattr(pt_module, cls)(_Space((3,)), space, {})
    box = _Space((1,), low=np.zeros(1), high=np.ones(1))
    assert pt_module.SACModule(_Space((3,)), box, {}).action_dist_cls is pt_dist.SquashedGaussian
    assert pt_module.DQNModule(_Space((3,)), _Space(n=3), {}).action_dist_cls is \
        pt_dist.EpsilonGreedyQ


# ---- one update of each learner ----------------------------------------------------

LEARNERS = {
    "dqn": (JaxDQNConfig, JaxDQNLearner, "DQNModule", "DQNConfig", "DQNLearner"),
    "sac": (JaxSACConfig, JaxSACLearner, "SACModule", "SACConfig", "SACLearner"),
    "cql": (JaxCQLConfig, JaxCQLLearner, "SACModule", "CQLConfig", "CQLLearner"),
    "marwil": (JaxMARWILConfig, JaxMARWILLearner, "MLPModule", "MARWILConfig", "MARWILLearner"),
}

# name -> (learner, training kwargs); each gets its own JAX learner
CASES = {
    "dqn_double": ("dqn", dict(double_q=True)),  # targets unchanged (every 200)
    "dqn_single_polyak": ("dqn", dict(double_q=False, tau=0.3)),
    "dqn_prioritized_hard": ("dqn", dict(double_q=True, target_network_update_freq=1)),
    "sac": ("sac", dict(tau=0.2)),
    # bc_iters 1: the first update is a BC update, the next ones SAC's
    "cql": ("cql", dict(bc_iters=1, num_cql_actions=3, min_q_weight=2.0)),
    "marwil_beta0": ("marwil", dict(beta=0.0, minibatch_size=8)),
    "marwil_beta1": ("marwil", dict(beta=1.0, minibatch_size=8)),
}


def _configs(kind, **training):
    jax_cfg_cls, _, module, pt_cfg_cls, _ = LEARNERS[kind]
    act = DISCRETE if kind in ("dqn", "marwil") else BOX
    out = []
    for cfg, mod in ((jax_cfg_cls(), getattr(jax_module, module)),
                     (getattr(rllib, pt_cfg_cls)(), getattr(pt_module, module))):
        cfg = (cfg.training(train_batch_size=B, lr=1e-2, **training)
               .rl_module(model_config={"fcnet_hiddens": LEARNER_HIDDENS}).debugging(seed=3))
        out.append((cfg, mod))
    jax_spec = jax_module.RLModuleSpec(module_class=out[0][1], observation_space=OBS_SPACE,
                                       action_space=act, model_config=out[0][0].model_config)
    pt_spec = pt_module.RLModuleSpec(module_class=out[1][1], observation_space=OBS_SPACE,
                                     action_space=act, model_config=out[1][0].model_config)
    return out[0][0], jax_spec, out[1][0].learners(device="cpu"), pt_spec


def _pt_learner(kind, **training):
    _, _, pt_cfg, pt_spec = _configs(kind, **training)
    learner = getattr(rllib, LEARNERS[kind][4])(pt_cfg, pt_spec)
    learner.build()
    return learner


def _learners(kind, **training):
    """A JAX learner and a port learner from the same init. SAC's and CQL's
    policy head is scaled by 0.1 in both, so the squash stays where f32
    resolves log(1 - tanh(u)^2): at saturation one ulp of the two libraries'
    tanh moves a log-density by ~1e-3 (test_module_forwards_match_jax holds
    that case to its ulp bound)."""
    jax_cfg, jax_spec, _, _ = _configs(kind, **training)
    jax_l = LEARNERS[kind][1](jax_cfg, jax_spec)
    jax_l.build()
    pt_l = _pt_learner(kind, **training)
    if kind in ("sac", "cql"):
        params = jax.tree_util.tree_map(np.array, jax_l.get_state()["params"])
        params["pi"][-1]["w"] *= np.float32(0.1)
        for learner in (jax_l, pt_l):  # CQL's counter stays at 0
            learner.set_state({"params": params, "num_updates": 0})
    return jax_l, pt_l


def _batch(kind, seed=0, prioritized=False):
    rng = np.random.default_rng(seed)
    discrete = kind in ("dqn", "marwil")
    batch = {"obs": rng.standard_normal((B, 5)).astype(np.float32),
             "next_obs": rng.standard_normal((B, 5)).astype(np.float32),
             "actions": (rng.integers(0, 4, B) if discrete
                         else rng.uniform(BOX.low, BOX.high, (B, 2)).astype(np.float32)),
             "rewards": rng.standard_normal(B).astype(np.float32),
             "dones": (rng.random(B) < 0.3).astype(np.float32)}
    if prioritized:
        batch["weights"] = rng.uniform(0.1, 1.0, B).astype(np.float32)
        batch["batch_indexes"] = rng.permutation(40)[:B].astype(np.int64)
    if kind == "marwil":
        batch["returns_to_go"] = rng.standard_normal(B).astype(np.float32) * 3
    return batch


def jax_noise(kind, jax_learner):
    """The noise of the JAX learner's next update, from its key splits
    (sac.py:132 and :83, cql.py:134 and :59), without advancing its key."""
    _, sub = jax.random.split(jax_learner._rng)
    cfg, mod = jax_learner.config, jax_learner.module
    a = mod.act_dim
    if kind == "sac":
        r1, r2 = jax.random.split(sub)
        draws = {"next": jax.random.normal(r1, (B, a)), "actor": jax.random.normal(r2, (B, a))}
    else:
        r1, r2, r3, r4, r5 = jax.random.split(sub, 5)
        n = cfg.num_cql_actions
        draws = {"next": jax.random.normal(r1, (B, a)),
                 "random_actions": jax.random.uniform(r2, (n, B, a), minval=jnp.asarray(mod.low),
                                                      maxval=jnp.asarray(mod.high)),
                 "current": jax.random.normal(r3, (n * B, a)),
                 "next_state": jax.random.normal(r4, (n * B, a)),
                 "actor": jax.random.normal(r5, (B, a))}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


def _plant_ties(kind, params):
    """DQN: actions 0 and 1 tie as the online net's maxima on every row (the
    first must win the double-Q argmax); SAC: the twin critics are one net,
    so every torch.minimum ties."""
    params = jax.tree_util.tree_map(np.array, params)
    if kind == "dqn":
        last = params["q"][-1]
        last["w"][:, 1] = last["w"][:, 0]
        last["b"][:2] = 20.0
        target = jax.tree_util.tree_map(np.array, params)
        target["q"][-1]["b"][1] += 5.0  # picking action 1 would show
        return params, target
    params["q2"] = jax.tree_util.tree_map(np.array, params["q1"])
    return params, {"q1": params["q1"], "q2": params["q2"]}


def _jax_form(jax_learner, state):
    """The port's get_state as the JAX learner's: the optimizer as optax's tree."""
    return {**state, "opt_state": _jax_opt_state(jax_learner, state)}


def _snapshot_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _snapshot(jax_learner):
    """A copy of the JAX learner's get_state: its SAC update replaces the
    entries of its target_params dict in place."""
    return _snapshot_tree(jax_learner.get_state())


@pytest.fixture(scope="module")
def jax_updates():
    """Per case, on one JAX learner (one compile each): its state before and
    after one update, its metrics and the noise it drew; a second update from
    there (the reference for the JAX-to-port state move); the port's state
    after its own first update loaded into it and updated once more (the
    reference for the port-to-JAX move); and for DQN and SAC, planted ties
    loaded into it and updated."""
    out = {}
    for case, (kind, training) in CASES.items():
        prioritized = case == "dqn_prioritized_hard"
        jax_l, pt_l = _learners(kind, **training)
        noisy = kind in ("sac", "cql")
        batch, batch2 = (_batch(kind, seed=s, prioritized=prioritized) for s in (0, 2))
        ref = dict(batch=batch, batch2=batch2, before=_snapshot(jax_l))
        ref["noise"] = jax_noise(kind, jax_l) if noisy else None
        ref["metrics"] = jax_l.update(batch)
        ref["state"] = _snapshot(jax_l)
        ref["noise2"] = jax_noise(kind, jax_l) if noisy else None
        ref["metrics2"] = jax_l.update(batch2)
        ref["state2"] = _snapshot(jax_l)
        if noisy:
            pt_l.draw_noise = lambda b, n=ref["noise"]: n
        pt_l.update(batch)
        ref["pt_state"] = pt_l.get_state()
        jax_l.set_state(_snapshot_tree(_jax_form(jax_l, ref["pt_state"])))
        ref["noise3"] = jax_noise(kind, jax_l) if noisy else None
        ref["metrics3"] = jax_l.update(batch2)
        ref["state3"] = _snapshot(jax_l)
        out[case] = ref
        if case in ("dqn_double", "sac"):
            params, target = _plant_ties(kind, ref["state3"]["params"])
            tie = dict(batch=_batch(kind, seed=1), state={
                "params": params, "target_params": target, "opt_state": ref["state3"]["opt_state"]})
            jax_l.set_state(_snapshot_tree(tie["state"]))
            tie["noise"] = jax_noise(kind, jax_l) if noisy else None
            tie["metrics"] = jax_l.update(tie["batch"])
            tie["after"] = _snapshot(jax_l)
            out[f"tie_{kind}"] = tie
    return out


def _pt_update(kind, training, batch, noise, state=None):
    _, pt_l = _learners(kind, **training)
    if state is not None:
        pt_l.set_state(state)
    if noise is not None:
        pt_l.draw_noise = lambda b: noise
    return pt_l, pt_l.update(batch)


@pytest.mark.parametrize("case", list(CASES))
def test_learner_update_matches_jax(jax_updates, case):
    """One update of each learner from the same init: every leaf and target
    within 1e-5 of max|ref|, the metrics within 1e-5; DQN's epsilon leaf
    unchanged; under BC (MARWIL beta 0) the value net unchanged."""
    kind, training = CASES[case]
    ref = jax_updates[case]
    pt_l, metrics = _pt_update(kind, training, ref["batch"], ref["noise"])
    state = pt_l.get_state()
    _assert_tree_close(state["params"], ref["state"]["params"], UPDATE_TOL, "params")
    _assert_metrics_close(metrics, ref["metrics"])
    assert pt_l.opt_state.count == (2 if kind == "marwil" else 1)
    if kind == "dqn":
        assert state["params"]["epsilon"] == 1.0
        np.testing.assert_allclose(metrics["_td_errors"], np.asarray(ref["metrics"]["_td_errors"]),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL)
        if "batch_indexes" in ref["batch"]:
            np.testing.assert_array_equal(metrics["_batch_indexes"],
                                          ref["metrics"]["_batch_indexes"])
    if kind in ("dqn", "sac", "cql"):
        _assert_tree_close(state["target_params"], ref["state"]["target_params"],
                           UPDATE_TOL, "target_params")
    if case == "marwil_beta0":
        _assert_tree_equal(state["params"]["vf"], ref["before"]["params"]["vf"], "vf under BC")
    if kind == "cql":
        assert pt_l._num_updates == 1 and ref["metrics"]["actor_loss"] != ref["metrics2"][
            "actor_loss"]


@pytest.mark.parametrize("kind", ["dqn", "sac"])
def test_planted_ties_match_jax(jax_updates, kind):
    """Tied maxima in the double-Q argmax (the first action must win) and
    tied twin critics in SAC's torch.minimum give JAX's update."""
    ref = jax_updates[f"tie_{kind}"]
    training = CASES["dqn_double" if kind == "dqn" else "sac"][1]
    pt_l, metrics = _pt_update(kind, training, ref["batch"], ref["noise"], ref["state"])
    if kind == "dqn":
        q = pt_l.module.q_values_np(ref["state"]["params"], ref["batch"]["next_obs"])
        assert (q[:, 0] == q[:, 1]).all() and (q.argmax(axis=1) == 0).all()
    after = pt_l.get_state()
    for key in ("params", "target_params"):
        _assert_tree_close(after[key], ref["after"][key], UPDATE_TOL, key)
    _assert_metrics_close(metrics, ref["metrics"])


def test_minimum_splits_the_gradient_at_a_tie_as_jax_does():
    x = np.array([1.0, 2.0, 3.0], np.float32)
    y = np.array([1.0, 5.0, 3.0], np.float32)
    c = np.array([2.0, 3.0, 4.0], np.float32)
    want = jax.grad(lambda a, b: jnp.sum(c * jnp.minimum(a, b)), argnums=(0, 1))(x, y)
    tx, ty = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
    torch.sum(torch.from_numpy(c) * torch.minimum(tx, ty)).backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(ty.grad.numpy(), np.asarray(want[1]))


# CQL's second update is SAC's branch (num_updates 1 = bc_iters)
STATE_CASES = ["dqn_prioritized_hard", "dqn_single_polyak", "sac", "cql", "marwil_beta1"]


@pytest.mark.parametrize("case", STATE_CASES)
def test_state_moves_from_jax_to_the_port(jax_updates, case):
    """The JAX learner's get_state (params with epsilon / log_alpha, optax's
    count, mu, nu, the targets, CQL's num_updates) loads into the port bit
    for bit, and the port's next update lands where the JAX learner's does."""
    kind, training = CASES[case]
    ref = jax_updates[case]
    _, pt_l = _learners(kind, **training)
    pt_l.set_state(ref["state"])
    if kind == "cql":
        assert pt_l._num_updates == 1  # the next update takes SAC's branch
    state = pt_l.get_state()
    _assert_tree_equal(state["params"], ref["state"]["params"], "params")
    adam = _adam_state(ref["state"]["opt_state"])
    assert state["opt_state"]["count"] == int(adam.count) == pt_l.opt_state.count
    _assert_tree_equal(state["opt_state"]["mu"], adam.mu, "mu")
    _assert_tree_equal(state["opt_state"]["nu"], adam.nu, "nu")
    if kind != "marwil":
        _assert_tree_equal(state["target_params"], ref["state"]["target_params"], "targets")
    if kind == "cql":
        assert state["num_updates"] == ref["state"]["num_updates"] == 1
    if ref["noise2"] is not None:
        pt_l.draw_noise = lambda b: ref["noise2"]
    _assert_metrics_close(pt_l.update(ref["batch2"]), ref["metrics2"])
    for key in ("params", "target_params") if kind != "marwil" else ("params",):
        _assert_tree_close(pt_l.get_state()[key], ref["state2"][key], SLICE_TOL, key)


@pytest.mark.parametrize("case", STATE_CASES)
def test_state_moves_from_the_port_to_jax(jax_updates, case):
    """The port's state after its update, with the optimizer as optax's tree,
    loads into the JAX learner, which updates from it where the port's
    learner updates from the same state."""
    kind, training = CASES[case]
    ref = jax_updates[case]
    _, pt_l = _learners(kind, **training)
    pt_l.set_state(ref["pt_state"])
    if ref["noise3"] is not None:
        pt_l.draw_noise = lambda b: ref["noise3"]
    _assert_metrics_close(pt_l.update(ref["batch2"]), ref["metrics3"])
    if kind == "cql":
        assert ref["state3"]["num_updates"] == 2
    for key in ("params", "target_params") if kind != "marwil" else ("params",):
        _assert_tree_close(pt_l.get_state()[key], ref["state3"][key], SLICE_TOL, key)


def test_learners_cast_columns_as_jax_does():
    """uint8 observations and f64 actions (offline rows' float lists) train
    exactly as their f32 copies: obs and next_obs cast on the device, f64
    narrowed at the upload."""
    batch = _batch("sac")
    wide = dict(batch, obs=np.round(batch["obs"] * 10).clip(0, 20).astype(np.uint8),
                next_obs=np.round(batch["next_obs"] * 10).clip(0, 20).astype(np.uint8),
                actions=batch["actions"].astype(np.float64))
    narrow = dict(wide, obs=wide["obs"].astype(np.float32),
                  next_obs=wide["next_obs"].astype(np.float32),
                  actions=wide["actions"].astype(np.float32))
    states = []
    for b in (wide, narrow):
        pt_l = _pt_learner("sac", tau=0.2)
        pt_l.draw_noise = lambda n, g=torch.Generator().manual_seed(0): {
            "next": torch.randn((n, 2), generator=g), "actor": torch.randn((n, 2), generator=g)}
        pt_l.update(b)
        states.append(pt_l.get_state())
    _assert_tree_equal(states[0]["params"], states[1]["params"], "cast")


def test_noise_comes_from_the_learners_own_generator():
    """Without a caller's draws, SAC and CQL draw from a torch.Generator on
    the learner's device seeded from config.seed: two learners agree, the
    draws have the shapes the losses read, CQL's uniform actions lie in the box."""
    draws = []
    for _ in range(2):
        pt_l = _pt_learner("cql", bc_iters=0, num_cql_actions=3)
        assert pt_l.generator.device.type == "cpu"
        draws.append(pt_l.draw_noise(B))
    assert {k: tuple(v.shape) for k, v in draws[0].items()} == {
        "next": (B, 2), "actor": (B, 2), "current": (3 * B, 2), "next_state": (3 * B, 2),
        "random_actions": (3, B, 2)}
    for k in draws[0]:
        torch.testing.assert_close(draws[0][k], draws[1][k], rtol=0, atol=0)
    rand = draws[0]["random_actions"].numpy()
    assert (rand >= BOX.low).all() and (rand <= BOX.high).all()


# ---- offline data --------------------------------------------------------------------

def _recorded_episodes():
    eps = _episodes(5)[:3]
    eps[1] = dict(eps[1], terminated=True, truncated=False)
    return eps


def test_offline_prelearner_and_rows_are_bit_equal():
    eps = _recorded_episodes()
    rows = pt_offline.episodes_to_rows(eps, start_eps_id=4)
    assert rows == jax_offline.episodes_to_rows(eps, start_eps_id=4)
    shuffled = [rows[i] for i in np.random.default_rng(0).permutation(len(rows))]
    _batches_equal(pt_offline.OfflinePreLearner(0.9)(shuffled),
                   jax_offline.OfflinePreLearner(0.9)(shuffled))


@pytest.mark.parametrize("fmt", ["json", "parquet", "dataset"])
def test_offline_data_reads_as_the_jax_package_reads(tmp_path, fmt):
    """A newline-JSON input_ (two files, read as ray_tpu.data.read_json reads
    each: pyarrow.json.read_json), a parquet directory (pyarrow) and a
    dataset= object give the JAX package's OfflinePreLearner batch, and
    OfflineData.sample draws the same rows."""
    import pyarrow as pa
    import pyarrow.json as pj
    import pyarrow.parquet as pq

    rows = pt_offline.episodes_to_rows(_recorded_episodes())
    halves = (rows[:9], rows[9:])
    cfg = rllib.MARWILConfig().training(gamma=0.95)
    if fmt == "json":
        paths = [str(tmp_path / f"part{i}.json") for i in range(2)]
        for path, part in zip(paths, halves):
            with open(path, "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in part)
        want_rows = [r for p in paths for r in pj.read_json(p).to_pylist()]
        cfg.offline_data(input_=paths)
    elif fmt == "parquet":
        for i, part in enumerate(halves):
            pq.write_table(pa.Table.from_pylist(part), str(tmp_path / f"part{i}.parquet"))
        want_rows = [r for i in range(2)
                     for r in pq.read_table(str(tmp_path / f"part{i}.parquet")).to_pylist()]
        cfg.offline_data(input_=str(tmp_path))
    else:
        want_rows = rows
        cfg.offline_data(dataset=chip_smoke._ListDataset(rows))
    data = pt_offline.OfflineData(cfg)
    want = jax_offline.OfflinePreLearner(0.95)(want_rows)
    _batches_equal(data.batch, want)
    got_s = data.sample(8, np.random.default_rng(1))
    idx = np.random.default_rng(1).integers(0, len(want["obs"]), size=8)
    _batches_equal(got_s, {k: v[idx] for k, v in want.items()})


def test_parquet_without_pyarrow_says_so(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    cfg = rllib.BCConfig().offline_data(input_=str(tmp_path / "rows.parquet"))
    with pytest.raises(ImportError, match="pyarrow"):
        pt_offline.OfflineData(cfg)


# ---- algorithms ----------------------------------------------------------------------

def _offline_algo(cls, dataset, space, **training):
    return (getattr(rllib, cls)().environment(observation_space=OBS_SPACE, action_space=space)
            .offline_data(dataset=dataset).training(**training)
            .rl_module(model_config={"fcnet_hiddens": HIDDENS})
            .learners(device="cpu").debugging(seed=0).build_algo())


def _continuous_rows():
    rows = pt_offline.episodes_to_rows(_episodes(2, continuous=True)[:3])
    for r in rows:
        r["obs"] = r["obs"] + [0.0, 0.5]  # OBS_SPACE is 5 wide
        r["next_obs"] = r["next_obs"] + [0.0, 0.5]
    return rows


def test_offline_algorithms_train_save_and_restore():
    """BC and CQL from dataset= objects: no runners, finite losses, evaluate
    without runners gives None, and a checkpoint round trip (CQL's num_updates
    too) is bit-equal; without spaces the offline path says what it needs."""
    rows = pt_offline.episodes_to_rows(_episodes(1)[:3])
    for r in rows:
        r["obs"], r["next_obs"] = r["obs"] + [0.1, 0.2], r["next_obs"] + [0.1, 0.2]
    bc = _offline_algo("BCConfig", chip_smoke._ListDataset(rows), DISCRETE,
                       train_batch_size=8, num_updates_per_iteration=3)
    cql = _offline_algo("CQLConfig", chip_smoke._ListDataset(_continuous_rows()), BOX,
                        train_batch_size=8, num_updates_per_iteration=3, bc_iters=2,
                        num_cql_actions=2)
    other = _offline_algo("CQLConfig", chip_smoke._ListDataset(_continuous_rows()), BOX,
                          train_batch_size=8, num_updates_per_iteration=3, bc_iters=2,
                          num_cql_actions=2)
    try:
        assert bc.env_runner_group is None and cql.env_runner_group is None
        result = bc.train()
        assert np.isfinite(result["policy_loss"]) and result["mean_logp"] < 0
        assert bc.evaluate()["evaluation"]["episode_return_mean"] is None
        result = cql.train()
        assert np.isfinite(result["critic_loss"]) and np.isfinite(result["cql_loss"])
        other.load_checkpoint(cql.save_checkpoint())
        a, b = cql.learner_group.get_state(), other.learner_group.get_state()
        assert a["num_updates"] == b["num_updates"] == 3
        for key in ("params", "target_params"):
            _assert_tree_equal(b[key], a[key], key)
    finally:
        for algo in (bc, cql, other):
            algo.stop()
    with pytest.raises(ValueError, match="observation_space"):
        rllib.BCConfig().offline_data(dataset=chip_smoke._ListDataset(rows)).learners(
            device="cpu").build_algo()


def test_config_copy_shares_the_dataset():
    ds = chip_smoke._ListDataset([{"obs": [0.0]}])
    cfg = rllib.CQLConfig().offline_data(dataset=ds, input_="x.json")
    new = cfg.copy()
    assert new.input_dataset is ds and cfg.input_dataset is ds and new.input_ == "x.json"


@pytest.mark.parametrize("kind", ["dqn", "sac"])
def test_runner_episodes_are_bit_equal(kind):
    """A runner of each package with the algorithm's module (epsilon-greedy
    at epsilon 0.4; the squashed Gaussian) at the same params and seed: the
    episodes, their actions and logp bit-equal, two samples in a row."""
    env_id, cfgs = ("CartPole-v1", (JaxDQNConfig(), rllib.DQNConfig())) if kind == "dqn" \
        else ("Pendulum-v1", (JaxSACConfig(), rllib.SACConfig()))
    cfgs = [c.environment(env_id).env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                                              rollout_fragment_length=16)
            .rl_module(model_config={"fcnet_hiddens": HIDDENS}).debugging(seed=2) for c in cfgs]
    jax_r, pt_r = JaxRunner(cfgs[0], 1), rllib.SingleAgentEnvRunner(cfgs[1].learners(device="cpu"), 1)
    params = jax_r.params
    if kind == "dqn":
        params = dict(params, epsilon=np.float32(0.4))
    jax_r.set_weights(params)
    pt_r.set_weights(params)
    try:
        for _ in range(2):
            want, got = jax_r.sample(60), pt_r.sample(60)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _batches_equal({k: np.asarray(v) for k, v in g.items()},
                               {k: np.asarray(v) for k, v in w.items()})
    finally:
        jax_r.stop()
        pt_r.stop()


# ---- two DQN iterations against the JAX package's classes ---------------------------

DQN_SLICE = dict(runners=2, envs=2, fragment=16, steps=64, batch=32, learning_starts=32,
                 updates=4, target_freq=3, epsilon_timesteps=200)


def _dqn_configure(cfg):
    s = DQN_SLICE
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=s["runners"], num_envs_per_env_runner=s["envs"],
                         rollout_fragment_length=s["fragment"])
            .training(train_batch_size=s["batch"], replay_buffer_capacity=1000,
                      num_steps_sampled_before_learning_starts=s["learning_starts"],
                      num_updates_per_iteration=s["updates"],
                      sample_timesteps_per_iteration=s["steps"],
                      target_network_update_freq=s["target_freq"],
                      epsilon_timesteps=s["epsilon_timesteps"])
            .rl_module(model_config={"fcnet_hiddens": LEARNER_HIDDENS}).debugging(seed=0))


@pytest.fixture(scope="module")
def dqn_port_run():
    """Two DQN.train() iterations of the port on the CPU: every batch its
    learner saw, the params and targets after each iteration."""
    algo = _dqn_configure(rllib.DQNConfig()).learners(device="cpu").build_algo()
    batches, update = [], algo.learner_group.update

    def capture(batch):
        batches.append({k: v.copy() for k, v in batch.items()})
        return update(batch)

    algo.learner_group.update = capture
    out = {"batches": batches, "states": [], "results": []}
    try:
        for _ in range(2):
            out["results"].append(algo.train())
            out["states"].append(algo.learner_group.get_state())
        out["runner_epsilon"] = float(algo.env_runner_group.runners[0].params["epsilon"])
        out["buffer_len"] = len(algo.buffer)
    finally:
        algo.stop()
    return out


@pytest.fixture(scope="module")
def dqn_jax_run(dqn_port_run):
    """The same two iterations composed from the JAX package's classes in
    this process: 2 runners, the JAX ReplayBuffer, DQNLearner.update, the
    epsilon schedule and the weight sync. Iteration 2's updates are fed the
    port's batches (its epsilon-greedy picks follow argmax of Q, which one
    ulp of difference may flip)."""
    s = DQN_SLICE
    cfg = _dqn_configure(JaxDQNConfig())
    runners = [JaxRunner(cfg, i) for i in range(s["runners"])]
    spec = jax_module.RLModuleSpec(module_class=jax_module.DQNModule,
                                   observation_space=gym.make("CartPole-v1").observation_space,
                                   action_space=gym.spaces.Discrete(2),
                                   model_config=cfg.model_config)
    learner = JaxDQNLearner(cfg, spec)
    learner.build()
    buffer = jax_replay.ReplayBuffer(cfg.replay_buffer_capacity, n_step=cfg.n_step,
                                     gamma=cfg.gamma)
    rng = np.random.default_rng(0)
    env_steps = 0

    def sync():
        w = dict(learner.get_weights())
        e0, e1 = cfg.epsilon
        w["epsilon"] = np.float32(e0 + (e1 - e0) * min(1.0, env_steps / s["epsilon_timesteps"]))
        for r in runners:
            r.set_weights(w)

    sync()
    batches, states, metrics = [], [], []
    episodes = []
    for r in runners:
        episodes += r.sample(s["steps"] // s["runners"])
    env_steps += buffer.add_episodes(episodes)
    for _ in range(s["updates"]):
        batches.append(buffer.sample(s["batch"], rng))
        metrics.append(learner.update(batches[-1]))
    sync()
    states.append(learner.get_state())
    for b in dqn_port_run["batches"][s["updates"]:]:
        metrics.append(learner.update(b))
    states.append(learner.get_state())
    for r in runners:
        r.stop()
    return {"batches": batches, "states": states, "metrics": metrics, "env_steps": env_steps}


def test_dqn_slice_first_iteration_batches_are_bit_equal(dqn_port_run, dqn_jax_run):
    """Iteration 1 (epsilon 1): the runners, the buffer and its sampler give
    the JAX package's bits."""
    assert len(dqn_port_run["batches"]) == 2 * DQN_SLICE["updates"]
    for got, want in zip(dqn_port_run["batches"], dqn_jax_run["batches"]):
        _batches_equal(got, want)


@pytest.mark.parametrize("iteration", [1, 2])
def test_dqn_slice_matches_jax_after_each_iteration(dqn_port_run, dqn_jax_run, iteration):
    """Params and targets (one hard sync in each iteration: every 3 updates)
    within 1e-4 of max|ref| per leaf; the iteration's result and epsilon."""
    got, want = dqn_port_run["states"][iteration - 1], dqn_jax_run["states"][iteration - 1]
    for key in ("params", "target_params"):
        _assert_tree_close(got[key], want[key], SLICE_TOL, f"{key}, iteration {iteration}")
    result = dqn_port_run["results"][iteration - 1]
    assert result["training_iteration"] == iteration
    steps = result["num_env_steps_sampled_lifetime"]  # each runner steps >= 32 times
    if iteration == 1:
        assert steps == dqn_jax_run["env_steps"] >= DQN_SLICE["steps"]
    assert result["epsilon"] == pytest.approx(
        1.0 - 0.95 * min(1.0, steps / DQN_SLICE["epsilon_timesteps"]))
    n = DQN_SLICE["updates"]
    for k in ("total_loss", "mean_q", "mean_td_error"):  # the iteration's mean
        want = np.mean([m[k] for m in dqn_jax_run["metrics"][(iteration - 1) * n:iteration * n]])
        np.testing.assert_allclose(result[k], want, rtol=SLICE_TOL, atol=SLICE_TOL, err_msg=k)
    if iteration == 2:
        assert dqn_port_run["runner_epsilon"] == np.float32(result["epsilon"])


# ---- chip_smoke's env copies ----------------------------------------------------------

@pytest.mark.parametrize("env_id,cls", [("CartPole-v1", "CartPole"), ("Pendulum-v1", "Pendulum")])
def test_chip_smoke_envs_step_as_gymnasium(env_id, cls):
    """From the same seed and actions: reset, every step's obs, reward,
    terminated and truncated bit-equal to gym.make's (TimeLimit included),
    and the vector env bit-equal to gymnasium's SyncVectorEnv (next-step
    autoreset) over a few episodes."""
    rng = np.random.default_rng(0)
    ours, theirs = getattr(chip_smoke, cls)(), gym.make(env_id)

    def act(n=None):
        if cls == "CartPole":
            return rng.integers(0, 2, n) if n else int(rng.integers(0, 2))
        return rng.uniform(-3, 3, (n or 1, 1) if n else (1,)).astype(np.float32)

    for seed in (7, 8):
        np.testing.assert_array_equal(ours.reset(seed=seed)[0], theirs.reset(seed=seed)[0])
        for _ in range(600):
            a = act()
            got, want = ours.step(a), theirs.step(a)
            for g, w in zip(got[:4], want[:4]):
                assert np.asarray(g).dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g, w)
            if want[2] or want[3]:
                break
    vec = getattr(chip_smoke, cls).make_vec(3)
    ref = gym.vector.SyncVectorEnv([lambda: gym.make(env_id) for _ in range(3)])
    np.testing.assert_array_equal(vec.reset(seed=3)[0], ref.reset(seed=3)[0])
    for _ in range(450):
        a = act(3)
        for g, w in zip(vec.step(a)[:4], ref.step(a)[:4]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    ref.close()


# ---- chip_smoke's card-against-CPU comparison -----------------------------------------

@pytest.mark.parametrize("name", ["dqn", "sac", "marwil"])
def test_chip_smoke_update_comparison_sees_a_wrong_gradient(name):
    """update_against_cpu finds two equal updates equal, and a gradient twice
    its size (which adam's first, sign-like step hides from the parameters)
    wrong by its whole size, while the CPU's optimizer, fed that gradient,
    ends in the same state."""
    for double in (False, True):
        card, batch = chip_smoke._off_learner(name, "cpu")
        cpu, _ = chip_smoke._off_learner(name, "cpu")
        if double:
            grads = card._grads
            card._grads = lambda *a: (lambda loss, aux, g: (loss, aux, [2 * x for x in g]))(
                *grads(*a))
        got = chip_smoke.update_against_cpu(card, cpu, batch)
        assert got["steps"] == (2 if name == "marwil" else 1)
        assert got["state_err"] == 0.0
        assert got["grad_err"] == (1.0 if double else 0.0)
