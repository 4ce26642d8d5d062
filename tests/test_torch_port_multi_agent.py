"""Parity of the port's multi-agent RLlib slice (ray_tpu_torch/rllib:
MultiAgentEnv, make_multi_agent, MultiAgentEnvRunner, MultiAgentLearner,
MultiAgentPPO) with the JAX package.

The same seeds, weights and batches go through both packages on the CPU: the
runners' per-module episodes bit for bit (a shared policy, two policies, and
an env whose second agent joins mid-episode); one MultiAgentLearner update
within 1e-5 of max|ref| per leaf, per module; two MultiAgentPPO.train()
iterations of the port against the same iterations composed from the JAX
package's classes in-process, within 1e-4; and the learner's state moving
both ways. The JAX results are computed once per module; no cluster starts.
"""
import sys

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_util import one_torch_thread  # noqa: F401
from ray_tpu.rllib.algorithms.multi_agent_ppo import MultiAgentPPOConfig as JaxMAPPOConfig
from ray_tpu.rllib.algorithms.ppo import PPOLearner as JaxPPOLearner
from ray_tpu.rllib.connectors import GeneralAdvantageEstimation as JaxGAE
from ray_tpu.rllib.core.multi_learner import MultiAgentLearner as JaxMultiAgentLearner
from ray_tpu.rllib.env.multi_agent_env import make_multi_agent as jax_make_multi_agent
from ray_tpu.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner as JaxMARunner
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib.core import rl_module as pt_module
from ray_tpu_torch.rllib.core.learner import _adam_state

UPDATE_TOL = 1e-5  # one update: per leaf, of max|ref|; and the loss metrics
SLICE_TOL = 1e-4  # two train() iterations: per leaf, of max|ref|
HIDDENS = [32, 32]
# the slice: 2 runners, fragment 32, batch 128, minibatch 32, 2 epochs, 2 policies
SLICE = dict(runners=2, fragment=32, batch=128, minibatch=32, epochs=2)
METRICS = ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl")
MAPPINGS = {"shared": (["shared"], lambda aid: "shared"),
            "two": (["p0", "p1"], lambda aid: f"p{aid}")}


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


def _episodes_equal(got, want):
    assert sorted(got) == sorted(want)
    for mid in want:
        assert len(got[mid]) == len(want[mid]), mid
        for g, w in zip(got[mid], want[mid]):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                              err_msg=f"{mid}/{k}")


def _configure(cfg, make, mapping="two", env_config=None):
    policies, fn = MAPPINGS[mapping]
    return (cfg.environment(make, env_config=env_config or {"num_agents": 2})
            .multi_agent(policies=policies, policy_mapping_fn=fn)
            .env_runners(num_env_runners=SLICE["runners"],
                         rollout_fragment_length=SLICE["fragment"])
            .training(train_batch_size=SLICE["batch"], minibatch_size=SLICE["minibatch"],
                      num_epochs=SLICE["epochs"])
            .rl_module(model_config={"fcnet_hiddens": HIDDENS}).debugging(seed=0))


def _pt_config(mapping="two", make=None, env_config=None):
    make = make or rllib.make_multi_agent("CartPole-v1")
    return _configure(rllib.MultiAgentPPOConfig(), make, mapping, env_config).learners(
        device="cpu")


def _jax_config(mapping="two", make=None, env_config=None):
    make = make or jax_make_multi_agent("CartPole-v1")
    cfg = _configure(JaxMAPPOConfig(), make, mapping, env_config)
    cfg.base_learner_class = JaxPPOLearner
    return cfg


def _jax_opt_state(jax_learner, state):
    """The port's numpy optimizer state as a JAX sub-learner's optax tree."""
    opt = state["opt_state"]
    leaves = [opt["count"], *pt_module.tree_leaves(opt["mu"]),
              *pt_module.tree_leaves(opt["nu"])]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jax_learner.opt_state),
                                        leaves)


def _jax_form(jax_ma, state):
    return {mid: {"params": s["params"], "opt_state": _jax_opt_state(jax_ma._subs[mid], s)}
            for mid, s in state.items()}


# ---- the env, the config and the runner ----------------------------------------------

@pytest.mark.parametrize("maker", ["CartPole-v1", "class"])
def test_make_multi_agent_env_dict_api(maker, monkeypatch):
    """Three copies step as dicts keyed by agent, with "__all__"; a class
    maker needs no gymnasium, and each copy matches the JAX package's."""
    if maker == "class":
        monkeypatch.setitem(sys.modules, "gymnasium", None)
    env = rllib.make_multi_agent(chip_smoke.CartPole if maker == "class" else maker)(
        {"num_agents": 3})
    ref = jax_make_multi_agent(chip_smoke.CartPole if maker == "class" else maker)(
        {"num_agents": 3})
    obs, _ = env.reset(seed=0)
    want, _ = ref.reset(seed=0)
    assert set(obs) == {0, 1, 2} and env.possible_agents == [0, 1, 2]
    for aid in obs:
        np.testing.assert_array_equal(obs[aid], want[aid])
    for t in range(60):
        acts = {i: (t + i) % 2 for i in obs}
        got, want = env.step(acts), ref.step(acts)
        for g, w in zip(got[:4], want[:4]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        obs = got[0]
        if got[2]["__all__"]:
            break
    assert got[2]["__all__"] and got[3]["__all__"] is False
    env.close()


def test_multi_agent_config_and_specs():
    """policies as a list, a set or a dict; the mapping; spaces probed from the
    first agent mapped to a module, or given per module."""
    env = rllib.make_multi_agent("CartPole-v1")({"num_agents": 2})
    box, disc = gym.spaces.Box(-1, 1, (3,), np.float32), gym.spaces.Discrete(5)
    for policies in (["p0", "p1"], {"p0", "p1"}, {"p0": None, "p1": (box, disc)}):
        for make in (rllib.PPOConfig, JaxMAPPOConfig):
            cfg = make()
            assert not cfg.is_multi_agent and cfg.policy_mapping_fn(7) == "default_policy"
            cfg.multi_agent(policies=policies, policy_mapping_fn=lambda aid: f"p{aid}")
            assert cfg.is_multi_agent and sorted(cfg.policies) == ["p0", "p1"]
            specs = cfg.resolved_policy_specs(env)
            assert sorted(specs) == ["p0", "p1"]
            assert specs["p0"].observation_space.shape == (4,)
            want = (box, disc) if isinstance(policies, dict) else (
                env.observation_space, env.action_space)
            assert specs["p1"].observation_space == want[0]
            assert specs["p1"].action_space == want[1]
    assert sorted(rllib.PPOConfig().resolved_policy_specs(env)) == ["default_policy"]
    env.close()


class _JoinEnv(rllib.MultiAgentEnv):
    """Agent 0 from the start, agent 1 joining at step 3; agent 0 terminates
    at its 7th step and agent 1 at its 9th, after which the episode ends. A
    plain class both packages' runners can step (the observations depend on
    the actions, so the runner's picks show)."""

    def __init__(self, config=None):
        self.possible_agents = [0, 1]
        self.observation_space = gym.spaces.Box(-10, 10, (3,), np.float32)
        self.action_space = gym.spaces.Discrete(3)

    def reset(self, *, seed=None, options=None):
        self.t, self.pos = 0, {0: 0.0}
        return {0: self._obs(0)}, {}

    def _obs(self, aid):
        return np.array([self.pos[aid], self.t / 10.0, aid], np.float32)

    def step(self, action_dict):
        self.t += 1
        obs, rew, terms, truncs = {}, {}, {}, {}
        for aid, a in action_dict.items():
            self.pos[aid] += float(a) - 1.0
            done = (aid == 0 and self.t >= 7) or (aid == 1 and self.t >= 12)
            obs[aid], rew[aid], terms[aid], truncs[aid] = (self._obs(aid), self.pos[aid],
                                                           done, False)
            if done:
                del obs[aid]
        if self.t == 3:
            self.pos[1] = 0.5
            obs[1] = self._obs(1)
        terms["__all__"] = self.t >= 12
        truncs["__all__"] = False
        return obs, rew, terms, truncs, {}


@pytest.mark.parametrize("case", ["shared", "two", "join"])
def test_runner_episodes_are_bit_equal(case):
    """A runner of each package at the same params and seed: two samples in a
    row give the same per-module episodes (chunks of done agents, the final
    flush, an agent joining mid-episode), the same metrics, and a greedy one."""
    mapping = "shared" if case == "shared" else "two"
    make = _JoinEnv if case == "join" else None
    pt_r = rllib.MultiAgentEnvRunner(_pt_config(mapping, make), 1)
    jax_r = JaxMARunner(_jax_config(mapping, make), 1)
    rng = np.random.default_rng(4)
    params = {mid: jax.tree_util.tree_map(
        lambda a: (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32), p)
        for mid, p in jax_r.params.items()}  # away from init, so the policies differ
    pt_r.set_weights(params)
    jax_r.set_weights(params)
    try:
        for n, explore in ((40, True), (70, True), (30, False)):
            _episodes_equal(pt_r.sample(n, explore), jax_r.sample(n, explore))
            assert pt_r.get_metrics() == jax_r.get_metrics()
    finally:
        pt_r.stop()
        jax_r.stop()


# ---- the learner and two train() iterations ----------------------------------------

@pytest.fixture(scope="module")
def port_run():
    """Two MultiAgentPPO.train() iterations of the port on the CPU (policies
    p0, p1): the batches each update saw, the state after each iteration and
    the results."""
    algo = _pt_config().build_algo()
    batches, update = [], algo.learner_group.update

    def capture(batch):
        batches.append({mid: {k: v.copy() for k, v in b.items()} for mid, b in batch.items()})
        return update(batch)

    algo.learner_group.update = capture
    out = {"batches": batches, "states": [], "results": []}
    try:
        for _ in range(2):
            out["results"].append(algo.train())
            out["states"].append(algo.learner_group.get_state())
        out["eval"] = algo.evaluate(64)
    finally:
        algo.stop()
    return out


@pytest.fixture(scope="module")
def jax_run(port_run):
    """The same two iterations composed from the JAX package's classes in this
    process: 2 MultiAgentEnvRunners merged per module in runner order, the
    GAE connector per module, MultiAgentLearner.update and the weight sync.
    Iteration 2's update is fed the port's batches. Then the port's state
    after iteration 1, loaded into the JAX learner and updated on iteration
    2's batches (the reference of the port-to-JAX move)."""
    cfg = _jax_config()
    runners = [JaxMARunner(cfg, i) for i in range(SLICE["runners"])]
    probe = cfg.env_maker()()
    specs = cfg.resolved_policy_specs(probe)
    probe.close()
    learner = JaxMultiAgentLearner(cfg, specs)
    learner.build()
    modules = {mid: s.build() for mid, s in specs.items()}
    for r in runners:
        r.set_weights(learner.get_weights())
    samples = {}
    for r in runners:
        for mid, eps in r.sample(SLICE["batch"] // SLICE["runners"]).items():
            samples.setdefault(mid, []).extend(eps)
    weights = learner.get_weights()
    batch1 = {mid: JaxGAE(cfg.gamma, cfg.lambda_)(eps, module=modules[mid], params=weights[mid])
              for mid, eps in samples.items() if eps}
    out = {"batch1": batch1, "metrics": [learner.update(batch1)]}
    out["states"] = [jax.tree_util.tree_map(np.array, learner.get_state())]
    out["metrics"].append(learner.update(port_run["batches"][1]))
    out["states"].append(jax.tree_util.tree_map(np.array, learner.get_state()))
    learner.set_state(_jax_form(learner, port_run["states"][0]))
    learner.update(port_run["batches"][1])
    out["from_port"] = jax.tree_util.tree_map(np.array, learner.get_weights())
    for r in runners:
        r.stop()
    return out


def _pt_learner():
    cfg = _pt_config()
    cfg.base_learner_class = rllib.PPOLearner
    env = cfg.env_maker()()
    learner = rllib.MultiAgentLearner(cfg, cfg.resolved_policy_specs(env))
    env.close()
    learner.build()
    return learner


def test_learner_update_matches_jax(jax_run):
    """One MultiAgentLearner update on iteration 1's per-module batches: every
    leaf of each module within 1e-5 of max|ref|, each module's loss metrics
    within 1e-5; one sub-learner per policy, in sorted order, on the CPU."""
    learner = _pt_learner()
    assert list(learner._subs) == ["p0", "p1"]
    assert all(s.device.type == "cpu" for s in learner._subs.values())
    metrics = learner.update(jax_run["batch1"])
    want = jax_run["states"][0]
    for mid in ("p0", "p1"):
        _assert_tree_close(learner.get_weights()[mid], want[mid]["params"], UPDATE_TOL, mid)
        for k in METRICS:
            np.testing.assert_allclose(metrics[mid][k], jax_run["metrics"][0][mid][k],
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL, err_msg=f"{mid}/{k}")
        assert metrics[mid]["minibatch_steps"] == jax_run["metrics"][0][mid]["minibatch_steps"]


def test_slice_first_batches_are_bit_equal(port_run, jax_run):
    """Iteration 1's per-module train batches: runners, chunking, merging and
    GAE give the JAX package's bits."""
    got, want = port_run["batches"][0], jax_run["batch1"]
    assert sorted(got) == sorted(want) == ["p0", "p1"]
    for mid in want:
        assert sorted(got[mid]) == sorted(want[mid])
        for k in want[mid]:
            np.testing.assert_array_equal(got[mid][k], want[mid][k], err_msg=f"{mid}/{k}")


@pytest.mark.parametrize("iteration", [1, 2])
def test_slice_matches_jax_after_each_iteration(port_run, jax_run, iteration):
    """Each module's params within 1e-4 of max|ref| per leaf; the result's
    "{mid}/..." metrics those of the JAX learner's update; env steps trained."""
    got, want = port_run["states"][iteration - 1], jax_run["states"][iteration - 1]
    for mid in ("p0", "p1"):
        _assert_tree_close(got[mid]["params"], want[mid]["params"], SLICE_TOL,
                           f"{mid}, iteration {iteration}")
    result = port_run["results"][iteration - 1]
    assert result["training_iteration"] == iteration
    assert result["num_env_steps_trained"] == sum(
        len(b["obs"]) for b in port_run["batches"][iteration - 1].values())
    for mid in ("p0", "p1"):
        for k in METRICS:
            np.testing.assert_allclose(result[f"{mid}/{k}"],
                                       jax_run["metrics"][iteration - 1][mid][k],
                                       rtol=SLICE_TOL, atol=SLICE_TOL, err_msg=f"{mid}/{k}")
    assert port_run["eval"]["evaluation"]["episode_return_mean"] is not None


def test_state_moves_from_jax_to_the_port(port_run, jax_run):
    """The JAX learner's state after iteration 1, keyed by module with optax's
    count, mu and nu, loads into the port bit for bit; the port's next update
    lands where the JAX learner's does."""
    learner = _pt_learner()
    ref = jax_run["states"][0]
    learner.set_state(ref)
    state = learner.get_state()
    for mid in ("p0", "p1"):
        _assert_tree_equal(state[mid]["params"], ref[mid]["params"], mid)
        adam = _adam_state(ref[mid]["opt_state"])
        assert state[mid]["opt_state"]["count"] == int(adam.count) == \
            jax_run["metrics"][0][mid]["minibatch_steps"]
        _assert_tree_equal(state[mid]["opt_state"]["mu"], adam.mu, f"{mid} mu")
        _assert_tree_equal(state[mid]["opt_state"]["nu"], adam.nu, f"{mid} nu")
    learner.update(port_run["batches"][1])
    for mid in ("p0", "p1"):
        _assert_tree_close(learner.get_weights()[mid], jax_run["states"][1][mid]["params"],
                           UPDATE_TOL, mid)


def test_state_moves_from_the_port_to_jax(port_run, jax_run):
    """The port's state after iteration 1, as optax's trees, loads into the
    JAX learner, which updates from it where the port's learner does."""
    learner = _pt_learner()
    learner.set_state(port_run["states"][0])
    learner.update(port_run["batches"][1])
    for mid in ("p0", "p1"):
        _assert_tree_close(learner.get_weights()[mid], jax_run["from_port"][mid],
                           UPDATE_TOL, mid)


def test_separate_policies_checkpoint_round_trip():
    """tests/test_multi_agent.py's separate-policies case on the port: metric
    keys per module, a checkpoint restored bit for bit, p0 and p1 apart."""
    cfg = (rllib.MultiAgentPPOConfig()
           .environment(rllib.make_multi_agent(chip_smoke.CartPole), env_config={"num_agents": 2})
           .multi_agent(policies=["p0", "p1"], policy_mapping_fn=lambda aid: f"p{aid}")
           .env_runners(num_env_runners=1, rollout_fragment_length=32)
           .training(train_batch_size=128, minibatch_size=64, num_epochs=1)
           .rl_module(model_config={"fcnet_hiddens": HIDDENS})
           .learners(device="cpu").debugging(seed=0))
    algo = cfg.build_algo()
    try:
        result = algo.train()
        assert any(k.startswith("p0/") for k in result)
        assert any(k.startswith("p1/") for k in result)
        state = algo.save_checkpoint()
        w_before = algo.get_weights()
        algo.train()
        algo.load_checkpoint(state)
        w_after = algo.get_weights()
        _assert_tree_equal(w_after, w_before, "restored")
        runner = algo.env_runner_group.runners[0]
        _assert_tree_equal(runner.params, w_before, "synced to the runner")
        assert not np.allclose(w_after["p0"]["pi"][0]["w"], w_after["p1"]["pi"][0]["w"])
    finally:
        algo.stop()


def test_default_policy_without_multi_agent_call():
    """A MultiAgentPPOConfig with no .multi_agent() trains one default_policy."""
    cfg = (rllib.MultiAgentPPOConfig().environment(rllib.make_multi_agent(chip_smoke.CartPole))
           .env_runners(num_env_runners=1, rollout_fragment_length=16)
           .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
           .rl_module(model_config={"fcnet_hiddens": HIDDENS})
           .learners(device="cpu").debugging(seed=0))
    algo = cfg.build_algo()
    try:
        result = algo.train()
    finally:
        algo.stop()
    assert "default_policy/total_loss" in result and np.isfinite(
        result["default_policy/total_loss"])


def test_group_update_takes_a_module_dict(jax_run):
    """LearnerGroup over a module_id -> spec dict with MultiAgentLearner:
    update on a module_id -> batch dict updates each module and returns one
    {mid: metrics} per learner; non-array columns are dropped."""
    cfg = _pt_config()
    cfg.base_learner_class = rllib.PPOLearner
    env = cfg.env_maker()()
    group = rllib.LearnerGroup(cfg, cfg.resolved_policy_specs(env), rllib.MultiAgentLearner)
    env.close()
    batches = {mid: dict(b, note="x") for mid, b in jax_run["batch1"].items()}
    out = group.update(batches)
    assert len(out) == 1 and sorted(out[0]) == ["p0", "p1"]
    for mid in ("p0", "p1"):
        assert group.learners[0]._subs[mid].opt_state.count == out[0][mid]["minibatch_steps"] \
            == jax_run["metrics"][0][mid]["minibatch_steps"] > 0


def test_entry_point_refuses_a_silent_cpu(monkeypatch):
    """Without CUDA, the card's default raises before any env is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []

    def make(config):
        built.append(1)
        return chip_smoke.CartPole(config)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        rllib.MultiAgentPPOConfig().environment(rllib.make_multi_agent(make)).build_algo()
    assert not built
