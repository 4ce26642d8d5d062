"""Parity of the port's RLlib PPO slice (ray_tpu_torch/rllib) with the JAX package.

The same numpy inputs, seeds and weights go through both packages on the CPU:
distributions and the module forward within 1e-6, the host pieces (init,
apply_np, the GAE connector, a runner's samples) bit for bit, the GAE and
V-trace scans within 1e-6, one PPOLearner.update within 1e-5 of max|ref| per
leaf, and two PPO.train() iterations of the port against the same iterations
composed from the JAX package's classes in-process. The JAX results are
computed once per module; each JAX learner compiles one update.
"""
import sys

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import one_torch_thread  # noqa: F401
from ray_tpu.rllib.algorithms.ppo import PPOConfig as JaxPPOConfig
from ray_tpu.rllib.algorithms.ppo import PPOLearner as JaxPPOLearner
from ray_tpu.rllib.connectors import GeneralAdvantageEstimation as JaxGAE
from ray_tpu.rllib.core import distributions as jax_dist
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JaxRunner
from ray_tpu.rllib.utils import gae as jax_gae
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib.core import distributions as pt_dist
from ray_tpu_torch.rllib.core import rl_module as pt_module
from ray_tpu_torch.rllib.utils import gae as pt_gae

FWD_TOL = 1e-6  # distributions, module forward, scans: f32, another op order
UPDATE_TOL = 1e-5  # one update: per leaf, of max|ref|; and the loss metrics
SLICE_TOL = 1e-4  # two PPO iterations: per leaf, of max|ref|
GAMMA = 0.99
# the slice: 2 runners x 2 envs, fragment 32, batch 128, minibatch 32, 2 epochs
SLICE = dict(runners=2, envs=2, fragment=32, batch=128, minibatch=32, epochs=2)
METRICS = ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl")


def _configure(cfg, env="CartPole-v1", grad_clip=None):
    return (cfg.environment(env)
            .env_runners(num_env_runners=SLICE["runners"],
                         num_envs_per_env_runner=SLICE["envs"],
                         rollout_fragment_length=SLICE["fragment"])
            .training(train_batch_size=SLICE["batch"], minibatch_size=SLICE["minibatch"],
                      num_epochs=SLICE["epochs"], grad_clip=grad_clip)
            .debugging(seed=0))


def _pt_config(grad_clip=None):
    return _configure(rllib.PPOConfig(), grad_clip=grad_clip).learners(device="cpu")


def _spaces(env_id):
    env = gym.make(env_id)
    try:
        return env.observation_space, env.action_space
    finally:
        env.close()


def _specs(env_id="CartPole-v1"):
    obs, act = _spaces(env_id)
    return (JaxSpec(observation_space=obs, action_space=act, model_config={}),
            pt_module.RLModuleSpec(observation_space=obs, action_space=act, model_config={}))


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


def _assert_metrics_close(got, want):
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                   err_msg=k)
    assert got["minibatch_steps"] == want["minibatch_steps"]


def _jax_opt_state(jax_learner, state):
    """The port's numpy optimizer state as the JAX learner's optax tree."""
    opt = state["opt_state"]
    leaves = [opt["count"], *pt_module.tree_leaves(opt["mu"]),
              *pt_module.tree_leaves(opt["nu"])]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jax_learner.opt_state),
                                        leaves)


# ---- distributions and the module forward ------------------------------------

@pytest.mark.parametrize("name", ["Categorical", "DiagGaussian"])
def test_distribution_logp_and_entropy_match_jax(name):
    rng = np.random.default_rng(3)
    inputs = rng.standard_normal((32, 6)).astype(np.float32)
    if name == "Categorical":
        actions = rng.integers(0, 6, 32)
    else:
        actions = rng.standard_normal((32, 3)).astype(np.float32)
    pt_cls, jax_cls = getattr(pt_dist, name), getattr(jax_dist, name)
    x, a = torch.from_numpy(inputs), torch.from_numpy(actions)
    np.testing.assert_allclose(pt_cls.logp_torch(x, a).numpy(),
                               np.asarray(jax_cls.logp_jax(jnp.asarray(inputs),
                                                           jnp.asarray(actions))),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(pt_cls.entropy_torch(x).numpy(),
                               np.asarray(jax_cls.entropy_jax(jnp.asarray(inputs))),
                               rtol=FWD_TOL, atol=FWD_TOL)
    # the host side is the JAX package's numpy, bit for bit
    np.testing.assert_array_equal(pt_cls.logp_np(inputs, actions),
                                  jax_cls.logp_np(inputs, actions))
    np.testing.assert_array_equal(pt_cls.sample_np(inputs, np.random.default_rng(1)),
                                  jax_cls.sample_np(inputs, np.random.default_rng(1)))
    np.testing.assert_array_equal(pt_cls.greedy_np(inputs), jax_cls.greedy_np(inputs))


@pytest.mark.parametrize("env_id,dist", [("CartPole-v1", "Categorical"),
                                         ("Pendulum-v1", "DiagGaussian")])
def test_module_matches_jax(env_id, dist):
    """init_params and apply_np bit-equal, apply_torch within 1e-6 of
    apply_jax, on the same numpy params."""
    jax_spec, pt_spec = _specs(env_id)
    jax_mod, pt_mod = jax_spec.build(), pt_spec.build()
    assert pt_mod.action_dist_cls.__name__ == jax_mod.action_dist_cls.__name__ == dist
    params = jax_mod.init_params(seed=5)
    _assert_tree_equal(pt_mod.init_params(seed=5), params, "init_params")
    obs = np.random.default_rng(0).standard_normal(
        (16, *pt_spec.observation_space.shape)).astype(np.float32)
    want_np, got_np = jax_mod.apply_np(params, obs), pt_mod.apply_np(params, obs)
    want = jax_mod.apply_jax(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(obs))
    got = pt_mod.apply_torch(pt_module.params_from_numpy(params, "cpu"), torch.from_numpy(obs))
    for k in (rllib.Columns.ACTION_DIST_INPUTS, rllib.Columns.VF_PREDS):
        np.testing.assert_array_equal(got_np[k], want_np[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=k)


def test_module_tells_spaces_apart_without_gymnasium():
    """An integer n makes a space discrete; a Box-like space has none."""
    class Discrete:
        n = 4

    class Box:
        shape = (3,)

    assert pt_module.MLPModule(Box(), Discrete(), {}).action_dist_cls is pt_dist.Categorical
    cont = pt_module.MLPModule(Box(), Box(), {})
    assert cont.action_dist_cls is pt_dist.DiagGaussian and cont.out_dim == 6


def test_params_cross_the_packages_unchanged():
    jax_spec, _ = _specs()
    params = jax_spec.build().init_params(seed=2)
    tensors = pt_module.params_from_numpy(params, "cpu")
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in pt_module.tree_leaves(tensors))
    back = pt_module.to_numpy(tensors)
    _assert_tree_equal(back, params, "round trip")
    pt_module.tree_leaves(tensors)[0].add_(1.0)  # copies: neither side aliases the other
    _assert_tree_equal(back, params, "after a change to the tensors")
    # the leaf order is jax.tree_util's
    flat = jax.tree_util.tree_leaves(params)
    assert all(a is b for a, b in zip(pt_module.tree_leaves(params), flat))


# ---- scans ---------------------------------------------------------------------

def _packed_block(lambda_):
    """tests/test_gae_scan.py's layouts: episodes of 5, 1, 9, 3 packed in one
    column (terminated, truncated, truncated, terminated) beside two columns
    with other splits; boot[t] = vf[t+1] inside an episode."""
    rng = np.random.default_rng(11)
    T = 18
    splits = [[5, 1, 9, 3], [6, 12], [4, 4, 10]]
    flags = [[True, False, False, True], [True, False], [False, True, True]]
    rewards = rng.standard_normal((T, 3)).astype(np.float32)
    vf = rng.standard_normal((T, 3)).astype(np.float32)
    boot = rng.standard_normal((T, 3)).astype(np.float32)
    term = np.zeros((T, 3), np.float32)
    trunc = np.zeros((T, 3), np.float32)
    for b in range(3):
        t = -1
        for length, is_term in zip(splits[b], flags[b]):
            t += length
            (term if is_term else trunc)[t, b] = 1.0
        for i in range(T - 1):
            if term[i, b] == 0 and trunc[i, b] == 0:
                boot[i, b] = vf[i + 1, b]
    return rewards, vf, boot, term, trunc


@pytest.mark.parametrize("lambda_", [0.0, 0.95, 1.0])
def test_gae_scan_matches_jax(lambda_):
    block = _packed_block(lambda_)
    want = jax_gae.gae_scan(*block, gamma=GAMMA, lambda_=lambda_)
    got = pt_gae.gae_scan(*block, gamma=GAMMA, lambda_=lambda_)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (18, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_TOL, atol=FWD_TOL)


def test_gae_scan_truncation_bootstraps_termination_masks():
    one = lambda v: np.full((1, 1), v, np.float32)  # noqa: E731
    adv, targets = pt_gae.gae_scan(one(1.0), one(0.5), one(2.0), one(0.0), one(1.0),
                                   gamma=GAMMA, lambda_=0.95)
    np.testing.assert_allclose(adv.item(), np.float32(1.0 + GAMMA * 2.0 - 0.5), rtol=1e-6)
    np.testing.assert_allclose(targets.item(), adv.item() + 0.5, rtol=1e-6)
    adv, _ = pt_gae.gae_scan(one(1.0), one(0.5), one(2.0), one(1.0), one(0.0),
                             gamma=GAMMA, lambda_=0.95)
    np.testing.assert_allclose(adv.item(), 0.5, rtol=1e-6)  # the bootstrap is ignored


@pytest.mark.parametrize("lambda_", [0.95, 1.0])
def test_vtrace_block_matches_jax(lambda_):
    rewards, vf, boot, term, trunc = _packed_block(lambda_)
    rhos = np.exp(0.5 * np.random.default_rng(4).standard_normal(rewards.shape)).astype(
        np.float32)
    kw = dict(gamma=GAMMA, lambda_=lambda_, clip_rho_threshold=1.0, clip_pg_rho_threshold=0.9)
    want = jax_gae.vtrace_block(rewards, vf, boot, term, trunc, rhos, **kw)
    values = torch.tensor(vf, requires_grad=True)
    got = pt_gae.vtrace_block(rewards, values, boot, term, trunc, rhos, **kw)
    for g, w in zip(got, want):
        assert not g.requires_grad  # stop_gradient
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_TOL, atol=FWD_TOL)
    scan = pt_gae.vtrace_scan(torch.from_numpy(rewards), torch.from_numpy(1 - term),
                              torch.from_numpy(rhos))
    np.testing.assert_allclose(scan.numpy(), np.asarray(jax_gae.vtrace_scan(
        jnp.asarray(rewards), jnp.asarray(1 - term), jnp.asarray(rhos))),
        rtol=FWD_TOL, atol=FWD_TOL)


# ---- host pieces: runners and the GAE connector ---------------------------------

def _episodes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_runner_samples_and_gae_connector_are_bit_equal():
    """One runner (worker 1: the seeds' offsets) on CartPole at the same
    params and seed, two samples in a row (episodes carried across them):
    obs, actions, logp, values, rewards and episode cuts bit-equal, then the
    GAE connector's batch bit-equal."""
    jax_cfg = _configure(JaxPPOConfig())
    jax_runner, pt_runner = JaxRunner(jax_cfg, 1), rllib.SingleAgentEnvRunner(_pt_config(), 1)
    _assert_tree_equal(pt_runner.params, jax_runner.params, "runner params")
    for _ in range(2):
        want, got = jax_runner.sample(100), pt_runner.sample(100)
        _episodes_equal(got, want)
        assert pt_runner.get_metrics() == jax_runner.get_metrics()
    jax_batch = JaxGAE(GAMMA, 0.95)(want, module=jax_runner.module, params=jax_runner.params)
    pt_batch = rllib.GeneralAdvantageEstimation(GAMMA, 0.95)(
        got, module=pt_runner.module, params=pt_runner.params)
    _episodes_equal([pt_batch], [jax_batch])
    jax_runner.stop()
    pt_runner.stop()


# ---- the learner and the slice -----------------------------------------------------

@pytest.fixture(scope="module")
def port_run():
    """Two PPO.train() iterations of the port on the CPU; the batch each
    update saw, the params after it, and the learner's state after the first."""
    algo = _pt_config().build_algo()
    batches = []
    update = algo.learner_group.update

    def capture(batch):
        batches.append({k: v.copy() for k, v in batch.items()})
        return update(batch)

    algo.learner_group.update = capture
    out = {"batches": batches, "params": [], "results": []}
    try:
        for _ in range(2):
            out["results"].append(algo.train())
            out["params"].append(algo.get_weights())
            if len(out["params"]) == 1:
                out["state1"] = algo.learner_group.get_state()
    finally:
        algo.stop()
    return out


@pytest.fixture(scope="module")
def jax_run(port_run):
    """The same two iterations composed from the JAX package's classes in this
    process: 2 SingleAgentEnvRunners, the GAE connector, PPOLearner.update and
    the weight sync. Iteration 2's update is fed the port's batch."""
    cfg = _configure(JaxPPOConfig())
    runners = [JaxRunner(cfg, i) for i in range(SLICE["runners"])]
    jax_spec, _ = _specs()
    learner = JaxPPOLearner(cfg, jax_spec)
    learner.build()
    module = jax_spec.build()
    for r in runners:
        r.set_weights(learner.get_weights())
    episodes = []
    for r in runners:
        episodes += r.sample(SLICE["batch"] // SLICE["runners"])
    batch1 = JaxGAE(cfg.gamma, cfg.lambda_)(episodes, module=module,
                                            params=learner.get_weights())
    metrics1 = learner.update(batch1)
    params1 = learner.get_weights()
    metrics2 = learner.update(port_run["batches"][1])
    for r in runners:
        r.stop()
    return {"batch1": batch1, "params": [params1, learner.get_weights()],
            "metrics": [metrics1, metrics2]}


def _pt_learner(grad_clip):
    _, pt_spec = _specs()
    learner = rllib.PPOLearner(_pt_config(grad_clip), pt_spec)
    learner.build()
    return learner


@pytest.fixture(scope="module")
def clipped(jax_run):
    """grad_clip 0.5 on iteration 1's batch: the JAX learner's update and its
    state; a second update from that state; then the port's state after its
    own update, loaded into the JAX learner, and one more update there."""
    jax_spec, _ = _specs()
    learner = JaxPPOLearner(_configure(JaxPPOConfig(), grad_clip=0.5), jax_spec)
    learner.build()
    batch = jax_run["batch1"]
    out = {"metrics": learner.update(batch), "params": learner.get_weights(),
           "state": learner.get_state()}
    learner.update(batch)
    out["jax_continued"] = learner.get_weights()
    pt = _pt_learner(0.5)
    pt.update(batch)
    out["pt_state"] = pt.get_state()
    learner.set_state({"params": out["pt_state"]["params"],
                       "opt_state": _jax_opt_state(learner, out["pt_state"])})
    learner.update(batch)
    out["jax_from_pt"] = learner.get_weights()
    return out


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_ppo_learner_update_matches_jax(jax_run, clipped, grad_clip):
    """One update (2 epochs x 4 minibatches of 32) on one GAE batch: every leaf
    within 1e-5 of max|ref|, the loss metrics within 1e-5."""
    learner = _pt_learner(grad_clip)
    metrics = learner.update(jax_run["batch1"])
    want_params = jax_run["params"][0] if grad_clip is None else clipped["params"]
    want_metrics = jax_run["metrics"][0] if grad_clip is None else clipped["metrics"]
    _assert_tree_close(learner.get_weights(), want_params, UPDATE_TOL, "params")
    _assert_metrics_close(metrics, want_metrics)
    assert learner.opt_state.count == 8


def test_slice_first_batch_is_bit_equal(port_run, jax_run):
    """Iteration 1's train batch: the runners, episode chunking and the GAE
    connector of both packages give the same bits."""
    _episodes_equal([port_run["batches"][0]], [jax_run["batch1"]])


@pytest.mark.parametrize("iteration", [1, 2])
def test_slice_params_match_jax_after_each_iteration(port_run, jax_run, iteration):
    _assert_tree_close(port_run["params"][iteration - 1], jax_run["params"][iteration - 1],
                       SLICE_TOL, f"iteration {iteration}")
    result = port_run["results"][iteration - 1]
    assert result["training_iteration"] == iteration and result["done"] is False
    assert result["num_env_steps_trained"] == len(port_run["batches"][iteration - 1]["obs"])
    np.testing.assert_allclose(result["total_loss"],
                               jax_run["metrics"][iteration - 1]["total_loss"],
                               rtol=SLICE_TOL)


def test_state_moves_from_jax_to_the_port(clipped, jax_run):
    """The JAX learner's get_state loads into the port's learner bit for bit,
    and the next update there lands where the JAX learner's next update does."""
    learner = _pt_learner(0.5)
    learner.set_state(clipped["state"])
    state = learner.get_state()
    _assert_tree_equal(state["params"], clipped["state"]["params"], "params")
    adam = clipped["state"]["opt_state"][1][0]
    assert state["opt_state"]["count"] == int(adam.count) == 8
    _assert_tree_equal(state["opt_state"]["mu"], adam.mu, "mu")
    _assert_tree_equal(state["opt_state"]["nu"], adam.nu, "nu")
    learner.update(jax_run["batch1"])
    _assert_tree_close(learner.get_weights(), clipped["jax_continued"], UPDATE_TOL,
                       "continued")


def test_state_moves_from_the_port_to_jax(clipped, jax_run):
    """The port's state, as optax's tree, loads into the JAX learner, which
    updates from it where the port's learner updates from the same state."""
    learner = _pt_learner(0.5)
    learner.set_state(clipped["pt_state"])
    _assert_tree_equal(learner.get_state()["params"], clipped["pt_state"]["params"], "params")
    assert learner.opt_state.count == 8
    learner.update(jax_run["batch1"])
    _assert_tree_close(learner.get_weights(), clipped["jax_from_pt"], UPDATE_TOL,
                       "continued")


@pytest.mark.parametrize("column", ["obs", "actions"])
def test_learner_casts_columns_as_jax_does(column):
    """A uint8 OBS column trains exactly as its f32 copy (cast per minibatch),
    and so do Pendulum's f64 actions (DiagGaussian.sample_np's), which narrow
    to f32 as jax.device_put narrows them."""
    env_id, obs_dtype, act_dtype = {"obs": ("CartPole-v1", np.uint8, np.int64),
                                    "actions": ("Pendulum-v1", np.float32, np.float64)}[column]
    obs_space, act_space = _spaces(env_id)
    spec = pt_module.RLModuleSpec(observation_space=obs_space, action_space=act_space)
    rng = np.random.default_rng(0)
    n = 64
    actions = (rng.integers(0, 2, n) if column == "obs"
               else rng.standard_normal((n, 1)))
    batch = {"obs": rng.integers(0, 4, (n, obs_space.shape[0])).astype(obs_dtype),
             "actions": actions.astype(act_dtype), "action_logp": np.full(n, -0.69, np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32)}
    wide = dict(batch, **{column: batch[column].astype(np.float32)})
    learners = [rllib.PPOLearner(_pt_config(), spec) for _ in range(2)]
    for learner, b in zip(learners, (batch, wide)):
        learner.build()
        learner.update(b)
    _assert_tree_equal(learners[0].get_weights(), learners[1].get_weights(), column)


def test_ppo_loss_with_a_loss_mask_matches_jax():
    """compute_losses' loss_mask branch (the decoupled blocks' autoreset rows)
    against the JAX learner's, on the same params and batch."""
    jax_spec, pt_spec = _specs()
    rng = np.random.default_rng(1)
    n = 16
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "action_logp": rng.uniform(-1.2, -0.3, n).astype(np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32),
             "loss_mask": (rng.random(n) > 0.3).astype(np.float32)}
    cfg = _configure(JaxPPOConfig()).training(entropy_coeff=0.01)
    jax_learner = JaxPPOLearner(cfg, jax_spec)
    params = jax_spec.build().init_params(seed=0)
    want, want_aux = jax_learner.compute_losses(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    pt_learner = rllib.PPOLearner(_pt_config().training(entropy_coeff=0.01), pt_spec)
    got, got_aux = pt_learner.compute_losses(
        pt_module.params_from_numpy(params, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=FWD_TOL, atol=FWD_TOL)
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k].item(), float(want_aux[k]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=k)


def test_save_restore_evaluate(port_run):
    """save() after an iteration restores into a fresh algorithm: the same
    weights (runners synced too), the iteration count, and the learner's state."""
    algo = _pt_config().build_algo()
    other = _pt_config().build_algo()
    try:
        algo.train()
        payload = algo.save()
        assert payload["iteration"] == 1
        other.restore(payload)
        _assert_tree_equal(other.get_weights(), algo.get_weights(), "restored")
        _assert_tree_equal(other.env_runner_group.runners[1].params, algo.get_weights(),
                           "runner weights")
        _assert_tree_equal(other.get_weights(), port_run["params"][0], "iteration 1")
        assert other.train()["training_iteration"] == 2
        evaluation = algo.evaluate(200)["evaluation"]
        assert evaluation["episode_return_mean"] > 0
    finally:
        algo.stop()
        other.stop()


# ---- the card, gymnasium, and what the slice does not port --------------------------

@pytest.mark.parametrize("entry", ["build_algo", "PPOLearner", "params_from_numpy"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt_spec = _specs()
    calls = {
        "build_algo": lambda: rllib.PPOConfig().environment("CartPole-v1").build_algo(),
        "PPOLearner": lambda: rllib.PPOLearner(rllib.PPOConfig(), pt_spec),
        "params_from_numpy": lambda: pt_module.params_from_numpy({"w": np.zeros(2)}),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


class _Space:
    def __init__(self, shape=None, n=None):
        self.shape, self.n = shape, n


class _TinyVecEnv:
    """A make_vec env with gymnasium's next-step autoreset, uint8 obs and
    spaces of its own: what runs on a machine without gymnasium."""

    def __init__(self, num_envs, config):
        self.num_envs, self._t = num_envs, np.zeros(num_envs, np.int64)
        self._reset = np.zeros(num_envs, bool)

    def reset(self, *, seed=None, options=None):
        self._t[:] = 0
        self._reset[:] = False
        return np.zeros((self.num_envs, 3), np.uint8), {}

    def step(self, actions):
        self._t = np.where(self._reset, 0, self._t + 1)
        obs = np.stack([self._t % 5] * 3, axis=1).astype(np.uint8)
        rewards = np.where(self._reset, 0.0, (np.asarray(actions) == 1).astype(np.float64))
        term = ~self._reset & (self._t >= 8)
        self._reset = term.copy()
        return obs, rewards, term, np.zeros(self.num_envs, bool), {}

    def close(self):
        pass


class _TinyEnv:
    def __init__(self, config=None):
        self.observation_space, self.action_space = _Space(shape=(3,)), _Space(n=3)

    def close(self):
        pass

    @classmethod
    def make_vec(cls, num_envs, config=None):
        return _TinyVecEnv(num_envs, config)


def test_ppo_trains_a_make_vec_env_without_gymnasium(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    algo = (rllib.PPOConfig().environment(_TinyEnv)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=8)
            .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
            .learners(device="cpu").build_algo())
    try:
        results = [algo.train() for _ in range(3)]
    finally:
        algo.stop()
    assert [r["training_iteration"] for r in results] == [1, 2, 3]
    assert results[-1]["episode_return_mean"] is not None
    assert all(np.isfinite(r["total_loss"]) for r in results)


def test_a_string_env_without_gymnasium_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="gymnasium"):
        rllib.PPOConfig().environment("CartPole-v1").learners(device="cpu").build_algo()


@pytest.mark.parametrize("call,item", [
    (lambda: rllib.PPOConfig().decoupled_rollout(enabled=True), "A9c"),
    (lambda: rllib.PPOConfig().learners(num_learners=2), "A9b"),
    (lambda: rllib.IMPALAConfig().training(num_aggregator_actors_per_learner=1)
     .learners(device="cpu").build_algo(), "A9b"),
    (lambda: rllib.APPOConfig().training(num_aggregator_actors_per_learner=1)
     .learners(device="cpu").build_algo(), "A9b"),
])
def test_what_the_slice_does_not_port_raises_naming_its_item(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call()


def test_learner_group_refuses_more_learners_and_blocks():
    _, pt_spec = _specs()
    cfg = _pt_config()
    cfg.num_learners = 2
    with pytest.raises(NotImplementedError, match="A9b"):
        rllib.LearnerGroup(cfg, pt_spec, rllib.PPOLearner)
    group = rllib.LearnerGroup(_pt_config(), pt_spec, rllib.PPOLearner)
    with pytest.raises(NotImplementedError, match="A9c"):
        group.update_from_blocks([])
    # a module_id -> batch dict updates each module of a MultiAgentLearner
    cfg = _pt_config()
    cfg.base_learner_class = rllib.PPOLearner
    specs = {mid: pt_spec for mid in ("p0", "p1")}
    ma_group = rllib.LearnerGroup(cfg, specs, rllib.MultiAgentLearner)
    before = ma_group.get_weights()
    rng = np.random.default_rng(0)
    batch = {"obs": rng.standard_normal((32, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 32), "action_logp": np.full(32, -0.69, np.float32),
             "advantages": rng.standard_normal(32).astype(np.float32),
             "value_targets": rng.standard_normal(32).astype(np.float32)}
    out = ma_group.update({"p0": batch, "p1": dict(batch, advantages=-batch["advantages"])})
    assert len(out) == 1 and sorted(out[0]) == ["p0", "p1"]
    after = ma_group.get_weights()
    for mid in ("p0", "p1"):
        assert ma_group.learners[0]._subs[mid].opt_state.count == 2
        assert not np.array_equal(after[mid]["pi"][0]["w"], before[mid]["pi"][0]["w"])
    assert not np.array_equal(after["p0"]["pi"][0]["w"], after["p1"]["pi"][0]["w"])
