"""Parity of the port's IMPALA and APPO (ray_tpu_torch/rllib/algorithms/impala.py,
appo.py) with the JAX package's, on the CPU.

The same numpy episodes, params and seeds go through both packages:
pad_time_major bit for bit; the V-trace loss and its metrics within 1e-5 of
|ref| on a batch with ragged lengths, terminated and truncated pieces, padded
rows and off-policy behaviour log-probabilities; each step's gradients within
1e-5 of max|ref| per leaf against the JAX learner's jitted ``_update_fn``,
and the state after an update, the port's optimizer fed JAX's gradients,
within 1e-6; APPO's adaptive KL coefficient step for step; and two
IMPALA.train() iterations against the same iterations composed from the JAX
package's runner, pad_time_major and IMPALALearner, with the JAX algorithm's
issue order written out (a runner's next sample is issued before the update
and the weight sync, so iteration 2 trains on the initial policy's data).
No JAX runtime is started: the JAX side is built from its classes in-process.
"""
import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from _torch_port_util import one_torch_thread  # noqa: F401
from ray_tpu.rllib.algorithms.appo import APPOConfig as JaxAPPOConfig
from ray_tpu.rllib.algorithms.appo import APPOLearner as JaxAPPOLearner
from ray_tpu.rllib.algorithms.impala import IMPALAConfig as JaxIMPALAConfig
from ray_tpu.rllib.algorithms.impala import IMPALALearner as JaxIMPALALearner
from ray_tpu.rllib.algorithms.impala import pad_time_major as jax_pad_time_major
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JaxRunner
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib.algorithms.impala import pad_time_major
from ray_tpu_torch.rllib.core import rl_module as pt_module
from ray_tpu_torch.rllib.core.learner import _adam_state

LOSS_TOL = 1e-5  # the loss and every metric, of |ref|
GRAD_TOL = 1e-5  # each step's gradients, per leaf, of max|ref|
FED_TOL = 1e-6  # the state after an update fed JAX's gradients, per leaf, of max|ref|
MAX_T = 8  # the learner cases' max_seq_len
LENGTHS = (5, 12, 20, 1, 8, 3)  # 9 pieces at MAX_T 8: 5 | 8 4 | 8 8 4 | 1 | 8 | 3
DONE = ("terminated", "truncated", None, "terminated", "terminated", "truncated")
RHO_CLIPS = dict(vtrace_clip_rho_threshold=1.0, vtrace_clip_pg_rho_threshold=1.5)
# learner cases: (algorithm, action space, training kwargs)
CASES = {
    "impala": ("impala", "discrete", {}),
    "impala_box": ("impala", "box", {}),
    "appo": ("appo", "discrete", dict(clip_param=0.3)),
    "appo_kl": ("appo", "discrete", dict(clip_param=0.3, use_kl_loss=True, kl_coeff=0.4)),
}
SLICE = dict(runners=1, envs=2, fragment=32, batch=128, max_seq_len=32)
# one jitted JAX _update_fn per case: the loss reads none of the settings the
# tests vary (num_epochs, grad_clip), so each case compiles once
_JAX_UPDATE_FNS = {}


def _spaces(kind):
    if kind == "box":
        return (gym.spaces.Box(-1.0, 1.0, (5,), np.float32),
                gym.spaces.Box(-2.0, 2.0, (2,), np.float32))
    return gym.spaces.Box(-1.0, 1.0, (5,), np.float32), gym.spaces.Discrete(3)


def _configs(algo, **training):
    """The JAX config and the port's (on the CPU), both with `training`."""
    kw = dict(RHO_CLIPS, lr=1e-3, max_seq_len=MAX_T, **training)
    jax_cls, pt_cls = ((JaxIMPALAConfig, rllib.IMPALAConfig) if algo == "impala"
                       else (JaxAPPOConfig, rllib.APPOConfig))
    return (jax_cls().training(**kw).debugging(seed=0),
            pt_cls().training(**kw).learners(device="cpu").debugging(seed=0))


def _learners(case, **extra):
    """The JAX learner and the port's for a case, built on the same params."""
    algo, kind, training = CASES[case]
    obs_space, act_space = _spaces(kind)
    jax_cfg, pt_cfg = _configs(algo, **training, **extra)
    model = {"fcnet_hiddens": [32, 32]}
    jax_cls, pt_cls = ((JaxIMPALALearner, rllib.IMPALALearner) if algo == "impala"
                       else (JaxAPPOLearner, rllib.APPOLearner))
    jax_l = jax_cls(jax_cfg, JaxSpec(observation_space=obs_space, action_space=act_space,
                                     model_config=model))
    pt_l = pt_cls(pt_cfg, pt_module.RLModuleSpec(observation_space=obs_space,
                                                 action_space=act_space, model_config=model))
    jax_l.build()
    jax_l._update_fn = _JAX_UPDATE_FNS.setdefault(case, jax_l._update_fn)
    pt_l.build()
    params = _bridged_params(jax_l.module)
    jax_l.set_state({"params": params})
    pt_l.set_state({"params": params})
    return jax_l, pt_l


def _bridged_params(module):
    """The module's init at seed 3 with the near-zero policy head scaled up,
    so the policy is far from uniform and the ratios spread."""
    params = jax.tree_util.tree_map(np.array, module.init_params(seed=3))
    params["pi"][-1]["w"] *= 50.0
    return params


def _episodes(module, params, seed=0, lengths=LENGTHS, done=DONE, shift=None):
    """Episode chunks of `lengths` with the runner's keys; the behaviour
    logp is the policy's at `params` plus N(0, 0.7) noise (off-policy), or
    plus `shift` exactly."""
    rng = np.random.default_rng(seed)
    dist = module.action_dist_cls
    obs_dim = module.obs_dim
    out = []
    for T, d in zip(lengths, done):
        obs = rng.standard_normal((T, obs_dim)).astype(np.float32)
        logits = module.apply_np(params, obs)["action_dist_inputs"]
        if dist.__name__ == "Categorical":
            actions = rng.integers(0, logits.shape[-1], T)
        else:
            actions = rng.standard_normal((T, logits.shape[-1] // 2))  # f64, as sample_np's
        logp = dist.logp_np(logits, actions).astype(np.float32)
        logp += (np.float32(shift) if shift is not None
                 else rng.normal(0.0, 0.7, T).astype(np.float32))
        out.append({"obs": obs, "next_obs_last": rng.standard_normal(obs_dim).astype(np.float32),
                    "actions": actions, "rewards": rng.standard_normal(T).astype(np.float32),
                    "terminated": d == "terminated", "truncated": d == "truncated",
                    "action_logp": logp,
                    "vf_preds": np.zeros(T, np.float32)})
    return out


def _batch(jax_l, seed=0, shift=None, b_bucket=4):
    return jax_pad_time_major(_episodes(jax_l.module, jax_l.get_weights(), seed, shift=shift),
                              MAX_T, b_bucket)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _leaf_errors(got, want):
    """max|got - want| / max|want| per leaf (0 where both are all zero)."""
    out = []
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        diff, scale = float(np.max(np.abs(g - w))), float(np.max(np.abs(w)))
        out.append(diff / scale if scale else (0.0 if diff == 0 else np.inf))
    return out


def _assert_metrics_close(got, want, keys=None):
    for k in keys or want:
        assert abs(got[k] - float(want[k])) <= LOSS_TOL * abs(float(want[k])), (
            k, got[k], float(want[k]))


def _state_errors(pt_l, jax_l):
    got, want = pt_l.get_state(), jax_l.get_state()
    adam = _adam_state(want["opt_state"])
    assert got["opt_state"]["count"] == int(adam.count)
    return _leaf_errors(
        [*pt_module.tree_leaves(got["params"]), *pt_module.tree_leaves(got["opt_state"]["mu"]),
         *pt_module.tree_leaves(got["opt_state"]["nu"])],
        [*jax.tree_util.tree_leaves(want["params"]), *jax.tree_util.tree_leaves(adam.mu),
         *jax.tree_util.tree_leaves(adam.nu)])


def _fed_update(pt_l, jax_l, batch):
    """JAX's update on `batch`, recording each step's gradients; then the
    port's, where each step's own gradients are held to JAX's of that step
    and JAX's go to its optimizer. Returns each step's worst gradient error
    and both updates' metrics."""
    jax_grads, errs = [], []
    update_fn, own_grads = jax_l._update_fn, pt_l._grads

    def recording(params, b):
        loss, aux, grads = update_fn(params, b)
        jax_grads.append([np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
        return loss, aux, grads

    def fed(mbatch, *args):
        loss, aux, grads = own_grads(mbatch, *args)
        want = jax_grads[len(errs)]
        errs.append(max(_leaf_errors([g.numpy() for g in grads], want)))
        return loss, aux, [torch.from_numpy(w.copy()) for w in want]

    jax_l._update_fn, pt_l._grads = recording, fed
    try:
        m_jax = jax_l.update(batch)
        m_pt = pt_l.update(batch)
    finally:
        jax_l._update_fn = update_fn
        del pt_l._grads
    assert len(errs) == len(jax_grads) == max(1, pt_l.config.num_epochs)
    return errs, m_pt, m_jax


# ---- the padded batch ------------------------------------------------------------

def _fake_episode(rng, T, terminated=True, obs_dim=4, box=False):
    """tests/test_impala.py's _fake_episode, from a seeded generator."""
    return {"obs": rng.standard_normal((T, obs_dim)).astype(np.float32),
            "next_obs_last": rng.standard_normal(obs_dim).astype(np.float32),
            "actions": (rng.standard_normal((T, 2)) if box else rng.integers(0, 2, size=T)),
            "rewards": np.ones(T, np.float32), "terminated": terminated, "truncated": False,
            "action_logp": np.full(T, -0.69, np.float32), "vf_preds": np.zeros(T, np.float32)}


@pytest.mark.parametrize("layout", ["test_impala", "box", "f32_box_and_bucket_8"])
def test_pad_time_major_is_bit_equal_to_jax(layout):
    """tests/test_impala.py:27-37's layout (10 and 70 steps, max_T 32,
    b_bucket 4), and Box-action episodes (f64 and f32 actions of shape [2])
    with a truncated end and padded rows: every array bit-equal, dtypes too."""
    rng = np.random.default_rng(0)
    if layout == "test_impala":
        eps = [_fake_episode(rng, 10), _fake_episode(rng, 70, terminated=False)]
        args = (32, 4)
    else:
        eps = [_fake_episode(rng, T, terminated=T % 2 == 0, box=True) for T in (3, 33, 16)]
        eps[1]["truncated"] = True
        if layout != "box":
            for ep in eps:
                ep["actions"] = ep["actions"].astype(np.float32)
        args = (16, 4 if layout == "box" else 8)
    got, want = pad_time_major(eps, *args), jax_pad_time_major(eps, *args)
    _assert_batches_equal(got, want)
    if layout == "test_impala":
        assert got["lens"].tolist() == [10, 32, 32, 6]
        assert got["terminated"].tolist() == [1.0, 0.0, 0.0, 0.0]
        np.testing.assert_array_equal(got["obs_ext"][1, 32], eps[1]["obs"][32])
    else:
        assert got["actions"].shape[1:] == (16, 2) and got["mask"][-1].sum() == 0


def test_pad_time_major_of_the_port_runner_is_bit_equal_to_jax():
    """A port runner's episodes on CartPole (ragged chunks, terminated and
    cut ones), padded by both packages."""
    cfg = (rllib.IMPALAConfig().environment("CartPole-v1")
           .env_runners(num_envs_per_env_runner=3, rollout_fragment_length=16)
           .learners(device="cpu"))
    runner = rllib.SingleAgentEnvRunner(cfg, 0)
    try:
        eps = runner.sample(150) + runner.sample(60)
    finally:
        runner.stop()
    assert any(e["terminated"] for e in eps) and any(not e["terminated"] for e in eps)
    _assert_batches_equal(pad_time_major(eps, 16), jax_pad_time_major(eps, 16))


def test_configs_keep_the_jax_defaults():
    for jax_cfg, pt_cfg in ((JaxIMPALAConfig(), rllib.IMPALAConfig()),
                            (JaxAPPOConfig(), rllib.APPOConfig())):
        keys = [k for k in vars(jax_cfg)
                if k not in ("algo_class", "policy_mapping_fn") and hasattr(pt_cfg, k)]
        assert {k: getattr(pt_cfg, k) for k in keys} == {k: getattr(jax_cfg, k) for k in keys}
    assert (rllib.IMPALAConfig().max_seq_len, rllib.IMPALAConfig().minibatch_size,
            rllib.APPOConfig().clip_param, rllib.APPOConfig().kl_target) == (64, None, 0.4, 0.01)


# ---- the learners ------------------------------------------------------------------

@pytest.fixture(scope="module")
def losses():
    """Per case: the batch, and JAX's loss, metrics and gradients at the
    bridged params (its jitted _update_fn; for APPO with the KL term, with
    kl_coeff in the batch as JAX's update puts it)."""
    out = {}
    for case in CASES:
        jax_l, _ = _learners(case)
        batch = _batch(jax_l)
        jax_batch = dict(batch)
        if case == "appo_kl":
            jax_batch["kl_coeff"] = np.float32(jax_l._kl_coeff)
        loss, aux, grads = jax_l._update_fn(jax_l.params, jax_batch)
        out[case] = dict(batch=batch, loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                         grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(losses, case):
    """compute_losses on the bridged params: the total and every metric
    within 1e-5 of |ref|; the batch has padded rows, and ratios above both
    clips of rho and of the policy-gradient rho."""
    ref = losses[case]
    batch = ref["batch"]
    assert batch["mask"].sum(axis=1).tolist() == [5, 8, 4, 8, 8, 4, 1, 8, 3, 0, 0, 0]
    assert batch["terminated"].tolist()[:9] == [1, 0, 0, 0, 0, 0, 1, 1, 0]
    _, pt_l = _learners(case)
    on_dev = pt_l._upload(batch)
    if case == "appo_kl":
        on_dev["kl_coeff"] = torch.tensor(np.float32(pt_l._kl_coeff))
    loss, aux = pt_l.compute_losses(pt_l.params, on_dev)
    got = {"total_loss": loss.item(), **{k: v.item() for k, v in aux.items()}}
    _assert_metrics_close(got, {"total_loss": ref["loss"], **ref["aux"]})
    # off-policy: some rho above both clips, and the mean rho away from 1
    weights = pt_l.get_weights()
    obs = batch["obs_ext"][:, :MAX_T].reshape(-1, batch["obs_ext"].shape[-1])
    logits = pt_l.module.apply_np(weights, obs)["action_dist_inputs"]
    acts = batch["actions"].reshape((len(obs),) + batch["actions"].shape[2:])
    logp = pt_l.module.action_dist_cls.logp_np(logits, acts).reshape(batch["mask"].shape)
    rho = np.exp(logp - batch["behaviour_logp"])[batch["mask"] > 0]
    assert (rho > RHO_CLIPS["vtrace_clip_pg_rho_threshold"]).sum() >= 3
    assert (rho < 1.0).sum() >= 3


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(losses, case):
    """The gradients of every leaf within 1e-5 of max|ref| of JAX's, whose
    stop_gradients leave only the paths through the target logp and the
    values (the port runs the V-trace recursion detached)."""
    ref = losses[case]
    _, pt_l = _learners(case)
    on_dev = pt_l._upload(ref["batch"])
    if case == "appo_kl":
        on_dev["kl_coeff"] = torch.tensor(np.float32(pt_l._kl_coeff))
    _, _, grads = pt_l._grads(on_dev)
    errs = _leaf_errors([g.numpy() for g in grads], ref["grads"])
    assert max(errs) <= GRAD_TOL, errs


@pytest.mark.parametrize("case,epochs,grad_clip", [
    ("impala", 1, None), ("impala", 4, None), ("impala", 1, 0.5), ("impala", 4, 0.5),
    ("appo_kl", 4, 0.5), ("impala_box", 4, None)])
def test_update_matches_jax(case, epochs, grad_clip):
    """One update, num_epochs whole-batch steps: each step's gradients
    within 1e-5 of max|ref| of JAX's at that step; the port's optimizer fed
    JAX's gradients lands within 1e-6 of JAX's state (params, adam's count,
    mu and nu); the last epoch's metrics within 1e-5."""
    jax_l, pt_l = _learners(case, num_epochs=epochs, grad_clip=grad_clip)
    batch = _batch(jax_l, seed=1)
    errs, m_pt, m_jax = _fed_update(pt_l, jax_l, batch)
    assert max(errs) <= GRAD_TOL, errs
    assert max(_state_errors(pt_l, jax_l)) <= FED_TOL
    assert pt_l.opt_state.count == epochs
    _assert_metrics_close(m_pt, m_jax)
    assert sorted(m_pt) == sorted(m_jax)


def test_appo_kl_coeff_follows_jax():
    """Three APPO updates with the KL term, the behaviour logp shifted from
    the current policy's by +0.1 (KL above 2x the target: x1.5), -0.1
    (below 0.5x: x0.5) and +0.012 (between: unchanged): the coefficient and
    its sequence equal JAX's, as does every state after an update."""
    jax_l, pt_l = _learners("appo_kl")
    seq_pt, seq_jax = [pt_l._kl_coeff], [jax_l._kl_coeff]
    for i, shift in enumerate((0.1, -0.1, 0.012)):
        batch = _batch(jax_l, seed=10 + i, shift=shift)
        errs, m_pt, m_jax = _fed_update(pt_l, jax_l, batch)
        assert max(errs) <= GRAD_TOL and max(_state_errors(pt_l, jax_l)) <= FED_TOL
        _assert_metrics_close(m_pt, m_jax)
        seq_pt.append(m_pt["kl_coeff"])
        seq_jax.append(m_jax["kl_coeff"])
    assert seq_pt == seq_jax == [0.4, 0.4 * 1.5, 0.4 * 1.5 * 0.5, 0.4 * 1.5 * 0.5]
    assert pt_l.get_state()["kl_coeff"] == jax_l.get_state()["kl_coeff"]


def test_vtrace_matches_one_step_td():
    """tests/test_impala.py:40-68 on the port: on-policy logp (rho = c = 1)
    and T = 1 make the V-trace target r + gamma V(next), so vf_loss is
    0.5 (r + gamma V(next) - V(s))^2 and mean_rho is 1."""
    env = gym.make("CartPole-v1")
    spec = pt_module.RLModuleSpec(observation_space=env.observation_space,
                                  action_space=env.action_space, model_config={})
    env.close()
    cfg = rllib.IMPALAConfig().environment("CartPole-v1").learners(device="cpu")
    learner = rllib.IMPALALearner(cfg, spec)
    learner.build()
    ep = _fake_episode(np.random.default_rng(0), 1, terminated=False)
    weights = learner.get_weights()
    out = learner.module.apply_np(weights, ep["obs"])
    ep["action_logp"] = learner.module.action_dist_cls.logp_np(
        out["action_dist_inputs"], ep["actions"])
    batch = pad_time_major([ep], max_T=1, b_bucket=1)
    _, aux = learner.compute_losses(learner.params, learner._upload(batch))
    v_s = float(out["vf_preds"][0])
    v_next = float(learner.module.apply_np(weights, ep["next_obs_last"][None])["vf_preds"][0])
    expected = 0.5 * (1.0 + cfg.gamma * v_next - v_s) ** 2
    np.testing.assert_allclose(aux["vf_loss"].item(), expected, rtol=1e-4)
    np.testing.assert_allclose(aux["mean_rho"].item(), 1.0, rtol=1e-5)


# ---- state across the packages -----------------------------------------------------

@pytest.fixture(scope="module")
def appo_states():
    """APPO with the KL term: JAX's state after one update, and the port's
    after its own (fed JAX's gradients) followed by a second, different one."""
    jax_l, pt_l = _learners("appo_kl", grad_clip=0.5)
    _fed_update(pt_l, jax_l, _batch(jax_l, seed=20, shift=0.1))
    jax_state = jax.tree_util.tree_map(np.array, jax_l.get_state())
    _fed_update(pt_l, jax_l, _batch(jax_l, seed=21, shift=-0.1))
    return dict(jax=jax_state, pt=pt_l.get_state(), batch=_batch(jax_l, seed=22, shift=0.1))


def test_state_moves_from_jax_to_the_port(appo_states):
    """JAX's APPO state (params, optax's count, mu and nu, kl_coeff) loads
    into the port bit for bit, and both continue to the same update."""
    want = appo_states["jax"]
    jax_l, pt_l = _learners("appo_kl", grad_clip=0.5)
    pt_l.set_state(want)
    jax_l.set_state(want)
    got = pt_l.get_state()
    assert got["kl_coeff"] == want["kl_coeff"] == 0.4 * 1.5
    assert max(_state_errors(pt_l, jax_l)) == 0.0
    errs, m_pt, m_jax = _fed_update(pt_l, jax_l, appo_states["batch"])
    assert max(errs) <= GRAD_TOL and max(_state_errors(pt_l, jax_l)) <= FED_TOL
    assert m_pt["kl_coeff"] == m_jax["kl_coeff"]


def test_state_moves_from_the_port_to_jax(appo_states):
    """The port's APPO state, its optimizer as optax's tree, loads into the
    JAX learner (kl_coeff too), and both continue to the same update."""
    state = appo_states["pt"]
    jax_l, pt_l = _learners("appo_kl", grad_clip=0.5)
    opt = state["opt_state"]
    leaves = [opt["count"], *pt_module.tree_leaves(opt["mu"]),
              *pt_module.tree_leaves(opt["nu"])]
    jax_l.set_state({"params": state["params"], "kl_coeff": state["kl_coeff"],
                     "opt_state": jax.tree_util.tree_unflatten(
                         jax.tree_util.tree_structure(jax_l.opt_state), leaves)})
    pt_l.set_state(state)
    assert jax_l._kl_coeff == pt_l._kl_coeff == state["kl_coeff"] == 0.4 * 1.5 * 0.5
    assert max(_state_errors(pt_l, jax_l)) == 0.0
    errs, m_pt, m_jax = _fed_update(pt_l, jax_l, appo_states["batch"])
    assert max(errs) <= GRAD_TOL and max(_state_errors(pt_l, jax_l)) <= FED_TOL
    assert m_pt["kl_coeff"] == m_jax["kl_coeff"]


# ---- the slice: two IMPALA iterations ----------------------------------------------

def _configure(cfg):
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=SLICE["runners"], num_envs_per_env_runner=SLICE["envs"],
                         rollout_fragment_length=SLICE["fragment"])
            .training(train_batch_size=SLICE["batch"], max_seq_len=SLICE["max_seq_len"])
            .debugging(seed=0))


@pytest.fixture(scope="module")
def port_run():
    """Two IMPALA.train() iterations of the port on the CPU: the batch each
    update saw, the weights before and after each, and the runner's weights
    after each iteration."""
    algo = _configure(rllib.IMPALAConfig()).learners(device="cpu").build_algo()
    out = {"batches": [], "weights": [algo.get_weights()], "results": [], "runner": []}
    update = algo.learner_group.update

    def capture(batch):
        out["batches"].append({k: v.copy() for k, v in batch.items()})
        return update(batch)

    algo.learner_group.update = capture
    try:
        for _ in range(2):
            out["results"].append(algo.train())
            out["weights"].append(algo.get_weights())
            out["runner"].append(algo.env_runner_group.runners[0].params)
        out["inflight"] = len(algo._inflight)
    finally:
        algo.stop()
    out["inflight_after_stop"] = len(algo._inflight)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The same two iterations composed from the JAX package's classes, in
    the JAX algorithm's order: setup syncs the initial weights; iteration 1
    issues sample 1, takes it and issues sample 2 (which the actor runs
    before the weight sync that follows the update), pads sample 1 and
    updates; iteration 2 takes sample 2, issues sample 3 (with iteration 1's
    weights), pads sample 2 and updates."""
    cfg = _configure(JaxIMPALAConfig())
    env = gym.make("CartPole-v1")
    spec = JaxSpec(observation_space=env.observation_space, action_space=env.action_space,
                   model_config={})
    env.close()
    runner = JaxRunner(cfg, 0)
    learner = JaxIMPALALearner(cfg, spec)
    learner.build()
    runner.set_weights(learner.get_weights())
    per = SLICE["batch"] // SLICE["runners"]
    batches, metrics = [], []
    inflight = runner.sample(per, True)
    for _ in range(2):
        taken, inflight = inflight, runner.sample(per, True)
        batches.append(jax_pad_time_major(taken, cfg.max_seq_len))
        metrics.append(learner.update(batches[-1]))
        runner.set_weights(learner.get_weights())
    runner.stop()
    return {"batches": batches, "metrics": metrics}


@pytest.mark.parametrize("iteration", [1, 2])
def test_slice_batches_are_bit_equal(port_run, jax_run, iteration):
    _assert_batches_equal(port_run["batches"][iteration - 1], jax_run["batches"][iteration - 1])
    result = port_run["results"][iteration - 1]
    assert result["training_iteration"] == iteration
    assert result["num_env_steps_trained"] == int(port_run["batches"][iteration - 1]["mask"].sum())
    if iteration == 1:  # the same params and batch: the same step
        _assert_metrics_close(result, jax_run["metrics"][0], keys=list(jax_run["metrics"][0]))


def test_slice_lags_one_policy_version(port_run):
    """Iteration 2's behaviour logp is the initial policy's (the sample was
    taken before iteration 1's update reached the runner), not iteration
    1's; after each iteration the runner holds the learner's weights."""
    batch = port_run["batches"][1]
    module = pt_module.RLModuleSpec(
        observation_space=gym.spaces.Box(-np.inf, np.inf, (4,), np.float32),
        action_space=gym.spaces.Discrete(2)).build()
    mask = batch["mask"] > 0
    obs = batch["obs_ext"][:, :-1][mask]
    acts = batch["actions"][mask]

    def logp(w):
        return module.action_dist_cls.logp_np(module.apply_np(w, obs)["action_dist_inputs"], acts)

    w0, w1 = port_run["weights"][0], port_run["weights"][1]
    np.testing.assert_allclose(batch["behaviour_logp"][mask], logp(w0), rtol=0, atol=1e-6)
    assert np.max(np.abs(batch["behaviour_logp"][mask] - logp(w1))) > 1e-4
    for i in (1, 2):
        for g, w in zip(pt_module.tree_leaves(port_run["runner"][i - 1]),
                        pt_module.tree_leaves(port_run["weights"][i])):
            np.testing.assert_array_equal(g, w)
    assert port_run["inflight"] == 1 and port_run["inflight_after_stop"] == 0


def _small_impala(**training):
    return (rllib.IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=16)
            .training(train_batch_size=64, max_seq_len=16, **training)
            .learners(device="cpu").debugging(seed=0).build_algo())


def test_broadcast_interval_two_skips_odd_updates():
    """broadcast_interval 2: after update 1 the runners keep the initial
    weights, after update 2 they hold the learner's."""
    algo = _small_impala(broadcast_interval=2)
    try:
        w0 = algo.get_weights()
        for it in (1, 2, 3):
            algo.train()
            want = w0 if it % 2 else algo.get_weights()
            assert not np.array_equal(algo.get_weights()["pi"][0]["w"], w0["pi"][0]["w"])
            for r in algo.env_runner_group.runners:
                for g, w in zip(pt_module.tree_leaves(r.params), pt_module.tree_leaves(want)):
                    np.testing.assert_array_equal(g, w)
            if it == 2:
                w0 = algo.get_weights()
    finally:
        algo.stop()


def test_runners_are_taken_in_order_and_a_failure_propagates():
    """Two runners: each iteration takes the oldest sample in flight and
    re-issues its runner; a runner's exception reaches the caller."""
    algo = _small_impala()
    try:
        order = []
        for r in algo.env_runner_group.runners:
            sample = r.sample

            def logged(*a, _i=r.worker_index, _s=sample):
                order.append(_i)
                return _s(*a)

            r.sample = logged
        algo.train()
        algo.train()
        assert order == [0, 1, 0, 1, 0, 1]
        assert list(algo._inflight) == [0, 1]

        def broken(*a):
            raise RuntimeError("env died")

        algo.env_runner_group.runners[0].sample = broken
        with pytest.raises(RuntimeError, match="env died"):
            algo.train()
    finally:
        algo.stop()
    assert not algo._inflight


@pytest.mark.parametrize("cls", ["IMPALA", "APPO"])
def test_algorithms_train_save_and_restore(cls):
    """Each algorithm trains, and a checkpoint (APPO's kl_coeff with it)
    restores bit for bit."""
    cfg = (getattr(rllib, f"{cls}Config")().environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=32)
           .training(train_batch_size=128, **({"clip_param": 0.3, "use_kl_loss": True}
                                              if cls == "APPO" else {}))
           .learners(device="cpu").debugging(seed=0))
    algo = cfg.build_algo()
    try:
        result = algo.train()
        assert np.isfinite(result["total_loss"]) and "mean_rho" in result
        state = algo.save_checkpoint()
        w_before = algo.get_weights()
        algo.train()
        algo.load_checkpoint(state)
        for g, w in zip(pt_module.tree_leaves(algo.get_weights()), pt_module.tree_leaves(w_before)):
            np.testing.assert_array_equal(g, w)
        if cls == "APPO":
            assert algo.learner_group.learners[0]._kl_coeff == state["learner"]["kl_coeff"]
    finally:
        algo.stop()
