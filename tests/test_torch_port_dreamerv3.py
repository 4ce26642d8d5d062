"""Parity of the port's DreamerV3 (ray_tpu_torch/rllib/algorithms/dreamerv3.py)
with the JAX package's.

The same numpy inputs, seeds, weights and Gumbel noise go through both
packages on the CPU, at tests/test_dreamerv3.py's geometry (deter 128,
hidden 128, embed 64, stoch 8 x 8, 8 sequences x 24 steps, horizon 15):
init_params and the stream buffer's windows bit for bit; the nets' pieces
within 1e-6; the world-model loss and its gradients and the actor-critic
losses and their gradients against the JAX learner's jitted ``_wm_fn`` and
``_ac_fn`` within 1e-5 of max|ref| per leaf; one whole update (parameters,
the three optimizers, the EMA critic, ret_range) within 1e-5; the runner's
``act_np`` against the JAX runner's ``act``; the learner's state both ways.

Every categorical draw on both sides is argmax(logp + gumbel). The JAX draws
come from the learner's key splits (``jax_noise``); the port is handed the
same noise. A pick whose top two scores differ by less than an ulp may flip
(a near tie, not a fault): the tests count the picks that differ, require
each to have a margin under 1e-5, and compare gradients with the port held to
JAX's picks (``idx=``). The JAX results are computed once per module.
"""
import functools
import sys

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_util import one_torch_thread  # noqa: F401
from ray_tpu.rllib.algorithms import dreamerv3 as jax_dv3
from ray_tpu.rllib.algorithms.algorithm_config import AlgorithmConfig as JaxAlgorithmConfig
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JaxSpec
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib.algorithms import dreamerv3 as pt_dv3
from ray_tpu_torch.rllib.core import rl_module as pt_module

FWD_TOL = 1e-6  # the nets' pieces and act_np: f32, another op order
UPDATE_TOL = 1e-5  # losses, gradients and one update: per leaf, of max|ref|
MOVED_TOL = 1e-4  # an update after a state move: adam's second step (see the offpolicy tests)
TIE_MARGIN = 1e-5  # a pick that differs must have its top two scores this close
GEOM = dict(deter_size=128, hidden=128, embed_size=64, stoch_groups=8, stoch_classes=8,
            batch_size_seqs=8, seq_len=24, imag_horizon=15, entropy_coef=1e-2)
OBS_SPACE = gym.spaces.Box(-5.0, 5.0, (4,), np.float32)
ACT_SPACE = gym.spaces.Discrete(2)


def _configure(cfg, **kw):
    return cfg.environment("CartPole-v1").training(**{**GEOM, **kw}).debugging(seed=0)


def _jax_learner():
    learner = jax_dv3.DreamerV3Learner(_configure(jax_dv3.DreamerV3Config()),
                                       JaxSpec(observation_space=OBS_SPACE,
                                               action_space=ACT_SPACE))
    learner.build()
    return learner


def _pt_learner():
    cfg = _configure(rllib.DreamerV3Config()).learners(device="cpu")
    learner = rllib.DreamerV3Learner(cfg, pt_module.RLModuleSpec(
        observation_space=OBS_SPACE, action_space=ACT_SPACE))
    learner.build()
    return learner


def _snap(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _leaf_err(g, w):
    g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w))), float(np.max(np.abs(w)))


def _assert_tree_close(got, want, tol, where):
    got_l, want_l = pt_module.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), where
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        err, scale = _leaf_err(g, w)
        assert err <= tol * scale, (where, i, err, scale)


def _assert_tree_equal(got, want, where):
    got_l, want_l = pt_module.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), where
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=where)


def _adam_leaves(opt):
    """(count, mu, nu) of the port's dict form or of optax's chain state."""
    if isinstance(opt, dict):
        return int(opt["count"]), opt["mu"], opt["nu"]
    adam = opt[1][0]
    return int(adam.count), adam.mu, adam.nu


def _assert_state_close(got, want, tol, where):
    _assert_tree_close(got["params"], want["params"], tol, f"{where} params")
    _assert_tree_close(got["critic_ema"], want["critic_ema"], tol, f"{where} critic_ema")
    for k in ("st_world", "st_actor", "st_critic"):
        (gc, gmu, gnu), (wc, wmu, wnu) = _adam_leaves(got[k]), _adam_leaves(want[k])
        assert gc == wc, (where, k)
        _assert_tree_close(gmu, wmu, tol, f"{where} {k} mu")
        _assert_tree_close(gnu, wnu, tol, f"{where} {k} nu")
    np.testing.assert_allclose(float(got["ret_range"]), float(want["ret_range"]), rtol=tol)


def _jax_form(jax_l, state):
    """The port's get_state as the JAX learner's: each optimizer as optax's tree."""
    out = _snap({k: state[k] for k in ("params", "critic_ema")})
    for k in ("st_world", "st_actor", "st_critic"):
        c, mu, nu = _adam_leaves(state[k])
        leaves = [np.int32(c), *pt_module.tree_leaves(mu), *pt_module.tree_leaves(nu)]
        out[k] = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(getattr(jax_l, k)), leaves)
    out["ret_range"] = float(state["ret_range"])
    return out


def jax_noise(jax_l, b, length):
    """The Gumbel draws of the JAX learner's next update, from its key: k1's
    split(L) for the world model's [B, K, C] draws; k2's split(H) for
    imagination, gumbel(key) [N, A] for the action and gumbel(fold_in(key,
    1)) [N, K, C] for z (one jitted program). Also returns k1 and k2."""
    cfg = jax_l.config
    kc = (cfg.stoch_groups, cfg.stoch_classes)
    shapes = ((b, *kc), (b * length, jax_l.nets.n_actions), (b * length, *kc))
    _, k1, k2 = jax.random.split(jax_l._rng, 3)
    noise = _gumbels(k1, k2, length, cfg.imag_horizon, shapes)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in zip(("wm", "act", "z"), noise)}, k1, k2


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _gumbels(k1, k2, length, horizon, shapes):
    keys = jax.random.split(k2, horizon)
    return (jax.vmap(lambda k: jax.random.gumbel(k, shapes[0]))(jax.random.split(k1, length)),
            jax.vmap(lambda k: jax.random.gumbel(k, shapes[1]))(keys),
            jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, 1), shapes[2]))(keys))


def _episodes(seed, lengths=(30, 12, 50, 7, 41), obs_dim=4):
    rng = np.random.default_rng(seed)
    out = []
    for i, t in enumerate(lengths):
        obs = rng.standard_normal((t + 1, obs_dim)).astype(np.float32)
        out.append({"obs": obs[:-1], "next_obs_last": obs[-1],
                    "actions": rng.integers(0, 2, t),
                    "rewards": rng.uniform(-1.0, 2.0, t).astype(np.float32),
                    "terminated": i % 2 == 0, "truncated": i % 2 == 1})
    return out


def _batches(n=3):
    buf = jax_dv3._StreamBuffer(1000, 4)
    buf.add_episodes(_episodes(0))
    rng = np.random.default_rng(0)
    return [buf.sample(GEOM["batch_size_seqs"], GEOM["seq_len"], rng) for _ in range(n)]


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _margins(scores):
    """Top-two margin of each pick: [..., C] scores -> [...]."""
    top2 = torch.topk(scores, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def _check_picks(scores, want_idx, where):
    """The port's free picks against JAX's: every pick that differs has a
    top-two margin under TIE_MARGIN. Returns (differing, smallest margin)."""
    got = scores.argmax(-1).numpy()
    margins = _margins(scores)
    diff = got != np.asarray(want_idx)
    assert (margins[diff] < TIE_MARGIN).all(), (where, int(diff.sum()), margins[diff])
    return int(diff.sum()), float(margins.min())


# ---- init, the stream buffer, the nets -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_are_bit_equal(seed):
    cfg = _configure(rllib.DreamerV3Config())
    got = pt_dv3._DreamerNets(4, 2, cfg).init_params(seed)
    want = jax_dv3._DreamerNets(4, 2, _configure(jax_dv3.DreamerV3Config())).init_params(seed)
    assert sorted(got) == sorted(want) == sorted(
        ("enc", "gru_r", "gru_u", "gru_c", "prior", "post", "dec", "rew", "cont", "actor",
         "critic"))
    _assert_tree_equal(got, want, "init_params")


def test_config_defaults_and_training_kwargs():
    got, want = rllib.DreamerV3Config(), jax_dv3.DreamerV3Config()
    own = set(vars(want)) - set(vars(JaxAlgorithmConfig())) | {"gamma", "grad_clip"}
    assert len(own) == 26
    for k in own:
        assert vars(got)[k] == vars(want)[k], k
    for c in (got, want):
        c.training(deter_size=64, lr_world=1e-3, train_batch_size=99, stoch_groups=None)
    assert (got.deter_size, got.lr_world, got.train_batch_size, got.stoch_groups) == (
        want.deter_size, want.lr_world, want.train_batch_size, want.stoch_groups) == (
        64, 1e-3, 99, 8)


def test_stream_buffer_is_bit_equal_across_a_wrap():
    """Episodes into a 64-row ring (it wraps twice), three windows of 24 after
    each round, with the same default_rng: storage and windows bit-equal."""
    bufs = [m._StreamBuffer(64, 4) for m in (jax_dv3, pt_dv3)]
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    for seed in (0, 1, 2):
        eps = _episodes(seed, lengths=(9, 20, 3))
        assert bufs[1].add_episodes(eps) == bufs[0].add_episodes(eps)
        assert (len(bufs[1]), bufs[1].ptr, bufs[1].full) == (
            len(bufs[0]), bufs[0].ptr, bufs[0].full)
        for k in ("obs", "actions", "rew_in", "terms", "is_first"):
            np.testing.assert_array_equal(getattr(bufs[1], k), getattr(bufs[0], k), err_msg=k)
        for _ in range(3):
            want, got = (b.sample(5, 24, r) for b, r in zip(bufs, rngs))
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert (got["is_first"][:, 0] == 1).all() and (got["rew_in"][:, 0] == 0).all()
    assert bufs[1].full


def test_stream_buffer_terminal_rows():
    """tests/test_dreamerv3.py:29-50 on the port's buffer."""
    buf = pt_dv3._StreamBuffer(1000, obs_dim=3)
    ep = {
        "obs": np.arange(12, dtype=np.float32).reshape(4, 3),
        "next_obs_last": np.full(3, 99.0, np.float32),
        "actions": np.array([1, 0, 1, 0]),
        "rewards": np.array([1.0, 1.0, 1.0, 5.0], np.float32),
        "terminated": True,
        "truncated": False,
    }
    assert buf.add_episodes([ep]) == 5  # 4 action states + the terminal state row
    assert buf.is_first[0] == 1.0 and buf.terms[4] == 1.0
    assert buf.obs[4][0] == 99.0
    assert buf.rew_in[4] == 5.0
    assert buf.rew_in[1] == 1.0 and buf.rew_in[0] == 0.0
    ep2 = dict(ep, terminated=False, truncated=True)
    assert buf.add_episodes([ep2]) == 5
    assert buf.terms[9] == 0.0 and buf.rew_in[9] == 5.0


@pytest.fixture(scope="module")
def nets():
    cfg_pt, cfg_jax = (_configure(c) for c in (rllib.DreamerV3Config(),
                                               jax_dv3.DreamerV3Config()))
    pt_n, jax_n = pt_dv3._DreamerNets(4, 2, cfg_pt), jax_dv3._DreamerNets(4, 2, cfg_jax)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(  # away from init: biases non-zero
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        pt_n.init_params(0))
    return pt_n, jax_n, params, pt_module.params_from_numpy(params, "cpu"), rng


def _close(got, want, tol=FWD_TOL):
    err, scale = _leaf_err(got.detach().numpy(), want)
    assert err <= tol * max(1.0, scale), (err, scale)


def test_nets_pieces_match_jax(nets):
    """gru, _logits (unimix), kl, feat, the five heads and symlog / symexp
    within 1e-6; sample_z with JAX's own noise: the same picks,
    straight-through values within 1e-6. The JAX side is one jitted program."""
    pt_n, jax_n, params, tparams, rng = nets
    n, d, zs = 16, 128, 64
    heads = ("decode", "reward", "cont", "actor_logits", "value")
    x = {"h": rng.standard_normal((n, d)), "raw": 3 * rng.standard_normal((n, zs)),
         "raw2": 3 * rng.standard_normal((n, zs)), "f": rng.standard_normal((n, d + zs)),
         "s": 4 * rng.standard_normal(50)}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    x["z"] = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (n, 8))].reshape(n, zs)
    x["a"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    key = jax.random.PRNGKey(11)

    @jax.jit
    def ref(params, x):
        lp, lp2 = jax_n._logits(x["raw"]), jax_n._logits(x["raw2"])
        return {"gru": jax_n.gru(params, x["h"], x["z"], x["a"]), "lp": lp,
                "kl": jax_n.kl(lp, lp2), "st": jax_n.sample_z(key, lp),
                "g": jax.random.gumbel(key, (n, 8, 8)), "feat": jax_n.feat(x["h"], x["z"]),
                "symlog": jax_dv3._symlog(x["s"]), "symexp": jax_dv3._symexp(x["s"]),
                **{h: getattr(jax_n, h)(params, x["f"]) for h in heads}}

    want = {k: np.array(v) for k, v in ref(params, x).items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    _close(pt_n.gru(tparams, t["h"], t["z"], t["a"]), want["gru"])
    lp, lp2 = pt_n._logits(t["raw"]), pt_n._logits(t["raw2"])
    _close(lp, want["lp"])
    _close(pt_n.kl(lp, lp2), want["kl"])
    st, scores = pt_n.sample_z(torch.from_numpy(want["lp"]), torch.from_numpy(want["g"]))
    np.testing.assert_array_equal(scores.argmax(-1).numpy(),
                                  want["st"].reshape(n, 8, 8).argmax(-1))
    _close(st, want["st"])
    _close(pt_n.feat(t["h"], t["z"]), want["feat"])
    for head in heads:
        _close(getattr(pt_n, head)(tparams, t["f"]), want[head])
    for fn in ("_symlog", "_symexp"):
        _close(getattr(pt_dv3, fn)(t["s"]), want[fn[1:]])


def test_straight_through_keeps_jax_order_and_gradient():
    """(onehot + probs) - sg(probs) in f32 is not exactly onehot: the port's
    value is JAX's to the bit, and its gradient reaches probs as JAX's does."""
    cfg = _configure(rllib.DreamerV3Config())
    pt_n = pt_dv3._DreamerNets(4, 2, cfg)
    jax_n = jax_dv3._DreamerNets(4, 2, _configure(jax_dv3.DreamerV3Config()))
    raw = np.random.default_rng(2).standard_normal((6, 64)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    g = np.asarray(jax.random.gumbel(key, (6, 8, 8)))
    w = np.random.default_rng(4).standard_normal((6, 64)).astype(np.float32)
    def st_fn(r):
        return jax_n.sample_z(key, jax_n._logits(r))

    want_st, want_g = jax.jit(lambda r: (st_fn(r), jax.grad(
        lambda q: jnp.sum(w * st_fn(q)))(r)))(raw)
    traw = torch.tensor(raw, requires_grad=True)
    st, _ = pt_n.sample_z(pt_n._logits(traw), torch.from_numpy(g))
    want_st = np.asarray(want_st)
    assert not np.array_equal(want_st, np.round(want_st))  # not exactly onehot
    err, _ = _leaf_err(st.detach().numpy(), want_st)
    assert err <= 1e-7
    (torch.from_numpy(w) * st).sum().backward()
    _close(traw.grad, np.asarray(want_g))


@pytest.mark.parametrize("op", ["free_bits", "relu"])
def test_maximum_splits_the_gradient_at_a_tie_as_jax_does(op):
    """Free bits (max(1, kl)) and the continue loss's max(logit, 0): at a tie
    torch.maximum, like jnp.maximum, gives each side half the gradient."""
    x = np.array([1.0, 0.5, 2.0, 0.0, -1.0], np.float32)
    c = 1.0 if op == "free_bits" else 0.0
    want = jax.grad(lambda v: jnp.sum(jnp.maximum(c, v) * jnp.arange(1.0, 6.0)))(x)
    tx = torch.tensor(x, requires_grad=True)
    (torch.maximum(tx.new_tensor(c), tx) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))


# ---- the learner: the two phases, one update, the state ------------------------------

def _jax_imagine_picks(jax_l, params, h0, z0, rng):
    """JAX's imagined actions and z picks for `_ac_fn`'s key, by the JAX
    package's own imagine step (its nets, _mlp and jax.random), jitted."""
    nets, horizon = jax_l.nets, jax_l.config.imag_horizon
    run = jax_l.__dict__.get("_test_imagine")  # one compile per learner
    if run is None:
        run = jax_l._test_imagine = jax.jit(_imagine_fn(nets, horizon))
    acts, z2s = run(params, h0, z0, rng)
    cfg = jax_l.config
    return (np.asarray(acts),
            np.asarray(z2s).reshape(*z2s.shape[:-1], cfg.stoch_groups,
                                    cfg.stoch_classes).argmax(-1))


def _imagine_fn(nets, horizon):
    def run(params, h0, z0, rng):
        def step(carry, key):
            hstate, z = carry
            f = nets.feat(hstate, z)
            a = jax.random.categorical(key, jax_dv3._mlp(params["actor"], f), axis=-1)
            h2 = nets.gru(params, hstate, z, jax.nn.one_hot(a, nets.n_actions, dtype=f.dtype))
            z2 = nets.sample_z(jax.random.fold_in(key, 1),
                               nets._logits(jax_dv3._mlp(params["prior"], h2)))
            return (h2, z2), (a, z2)

        return jax.lax.scan(step, (h0, z0), jax.random.split(rng, horizon))[1]

    return run


@pytest.fixture(scope="module")
def jax_run():
    """One JAX learner (each phase compiles once): the two phases on the
    initial params with its first keys; then updates 1 and 2 (state, metrics
    and noise of each); then the port's state after its own first update
    loaded into it and updated on batch 2 (the port-to-JAX reference)."""
    jax_l = _jax_learner()
    b1, b2, b3 = _batches()
    out = {"batches": (b1, b2, b3), "state0": _snap(jax_l.get_state())}
    noise, k1, k2 = jax_noise(jax_l, GEOM["batch_size_seqs"], GEOM["seq_len"])
    out["noise1"] = noise
    loss, aux, grads = jax_l._wm_fn(out["state0"]["params"], b1, k1)
    out["wm"] = dict(loss=float(loss), aux=_snap(aux), grads=_snap(grads))
    h0, z0 = aux["starts_h"], aux["starts_z"]
    ac = jax_l._ac_fn(out["state0"]["params"], out["state0"]["critic_ema"], h0, z0, k2, 1.7)
    out["ac"] = dict(loss=float(ac[0]), aux=_snap(ac[1]), g_actor=_snap(ac[2]),
                     g_critic=_snap(ac[3]), ret_range=1.7)
    out["ac"]["picks"] = _jax_imagine_picks(jax_l, out["state0"]["params"], h0, z0, k2)
    out["metrics1"] = jax_l.update(b1)
    out["state1"] = _snap(jax_l.get_state())
    # the gradients and picks inside update 1: the world model's are those
    # above; imagination runs on the stepped world model with the old actor
    # and critic, at ret_range 1.0
    mid = {**out["state1"]["params"], "actor": out["state0"]["params"]["actor"],
           "critic": out["state0"]["params"]["critic"]}
    ac1 = jax_l._ac_fn(mid, out["state0"]["critic_ema"], h0, z0, k2, 1.0)
    cfg = jax_l.config
    wm_idx = out["wm"]["aux"]["starts_z"].reshape(
        cfg.batch_size_seqs, cfg.seq_len, cfg.stoch_groups, cfg.stoch_classes).argmax(-1)
    out["update1"] = dict(grads=(out["wm"]["grads"], _snap(ac1[2]), _snap(ac1[3])),
                          picks=(wm_idx.transpose(1, 0, 2),
                                 *_jax_imagine_picks(jax_l, mid, h0, z0, k2)))
    out["noise2"], _, _ = jax_noise(jax_l, GEOM["batch_size_seqs"], GEOM["seq_len"])
    out["metrics2"] = jax_l.update(b2)
    out["state2"] = _snap(jax_l.get_state())
    pt_l = _pt_learner()
    pt_l.draw_noise = lambda b, length: noise
    pt_l.update(b1)
    out["pt_state1"] = pt_l.get_state()
    jax_l.set_state(_jax_form(jax_l, out["pt_state1"]))
    out["noise3"], _, _ = jax_noise(jax_l, GEOM["batch_size_seqs"], GEOM["seq_len"])
    out["metrics3"] = jax_l.update(b2)
    out["state3"] = _snap(jax_l.get_state())
    return out


def test_world_model_loss_and_gradients_match_jax(jax_run):
    """The world-model loss, its metrics, the detached starts and every
    gradient leaf against the JAX learner's jitted _wm_fn, with JAX's noise;
    the port's own picks are JAX's but for near ties, and the gradients are
    compared with the port held to JAX's picks."""
    pt_l = _pt_learner()
    batch, noise = _tensors(jax_run["batches"][0]), jax_run["noise1"]["wm"]
    ref = jax_run["wm"]
    cfg = pt_l.config
    want_idx = ref["aux"]["starts_z"].reshape(
        cfg.batch_size_seqs, cfg.seq_len, cfg.stoch_groups, cfg.stoch_classes).argmax(-1)
    want_idx = want_idx.transpose(1, 0, 2)  # [L, B, K]
    _, free = pt_l.wm_loss(pt_l.params, batch, noise)
    differ, margin = _check_picks(free["z_scores"], want_idx, "world model")
    assert free["z_scores"].shape == (24, 8, 8, 8) and margin > 0, (differ, margin)
    with torch.enable_grad():
        loss, aux = pt_l.wm_loss(pt_l.params, batch, noise, idx=torch.from_numpy(want_idx))
        grads = torch.autograd.grad(loss, pt_l._wm_leaves)
    assert abs(float(loss.detach()) - ref["loss"]) <= UPDATE_TOL * abs(ref["loss"])
    for k in ("wm_loss", "recon_loss", "reward_loss", "cont_loss", "kl_dyn", "kl_rep"):
        np.testing.assert_allclose(float(aux[k]), float(ref["aux"][k]), rtol=UPDATE_TOL,
                                   atol=UPDATE_TOL, err_msg=k)
    for k in ("starts_h", "starts_z"):
        assert not aux[k].requires_grad
        _assert_tree_close([aux[k].numpy()], [ref["aux"][k]], UPDATE_TOL, k)
    assert len(grads) == len(jax.tree_util.tree_leaves(ref["grads"])) == 30
    _assert_tree_close([g.numpy() for g in grads], ref["grads"], UPDATE_TOL, "wm grads")


def test_actor_critic_losses_and_gradients_match_jax(jax_run):
    """Imagination from JAX's starts, the lambda-returns, both losses, the
    percentiles and both gradients against the JAX learner's jitted _ac_fn
    (ret_range 1.7, so the advantage is divided), with JAX's noise; picks
    as in the world-model test."""
    pt_l = _pt_learner()
    ref, noise = jax_run["ac"], jax_run["noise1"]
    h0, z0 = (torch.from_numpy(np.asarray(jax_run["wm"]["aux"][k]))
              for k in ("starts_h", "starts_z"))
    frozen = pt_module.tree_map(lambda t: t.detach(), pt_l.params)
    args = (pt_l.params["actor"], pt_l.params["critic"], frozen, pt_l.critic_ema, h0, z0,
            noise["act"], noise["z"], ref["ret_range"])
    _, free = pt_l.ac_losses(*args)
    want_a, want_z = ref["picks"]
    counts = [_check_picks(free["a_scores"], want_a, "imagined actions"),
              _check_picks(free["z_scores"], want_z, "imagined z")]
    assert free["a_scores"].shape == (15, 192, 2), counts
    with torch.enable_grad():
        loss, aux = pt_l.ac_losses(*args, idx_a=torch.from_numpy(want_a).long(),
                                   idx_z=torch.from_numpy(want_z))
        grads = torch.autograd.grad(loss, pt_l._actor_leaves + pt_l._critic_leaves)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=UPDATE_TOL,
                               atol=UPDATE_TOL)
    for k in ("actor_loss", "critic_loss", "imag_return", "actor_entropy", "ret_p95",
              "ret_p5"):
        np.testing.assert_allclose(float(aux[k]), float(ref["aux"][k]), rtol=UPDATE_TOL,
                                   atol=UPDATE_TOL, err_msg=k)
    n = len(pt_l._actor_leaves)
    _assert_tree_close([g.numpy() for g in grads[:n]], ref["g_actor"], UPDATE_TOL, "actor")
    _assert_tree_close([g.numpy() for g in grads[n:]], ref["g_critic"], UPDATE_TOL, "critic")


def _fed_update(pt_l, batch, picks, grads):
    """pt_l.update(batch) held to JAX's picks, with each optimizer fed JAX's
    gradients of the same update (as chip_smoke's update_against_cpu feeds
    the CPU the card's). Returns the metrics and the port's own gradients."""
    own = {}
    wm_grads, ac_grads = pt_l._wm_grads, pt_l._ac_grads
    idx = [torch.from_numpy(np.asarray(p)).long() for p in picks]
    want = [[torch.from_numpy(np.array(g)) for g in jax.tree_util.tree_leaves(t)]
            for t in grads]

    def wm(b, noise, _idx=None):
        aux, g = wm_grads(b, noise, idx[0])
        own["wm"] = [x.numpy() for x in g]
        return aux, want[0]

    def ac(h0, z0, noise, _idx_a=None, _idx_z=None):
        aux, ga, gc = ac_grads(h0, z0, noise, idx[1], idx[2])
        own["actor"], own["critic"] = [x.numpy() for x in ga], [x.numpy() for x in gc]
        return aux, want[1], want[2]

    pt_l._wm_grads, pt_l._ac_grads = wm, ac
    try:
        return pt_l.update(batch), own
    finally:
        del pt_l._wm_grads, pt_l._ac_grads


def test_update_matches_jax(jax_run):
    """One whole update with JAX's noise and picks: the port's gradients of
    the world model, the actor and the critic within 1e-5 of JAX's per leaf;
    then, its optimizers fed JAX's gradients, the parameters, the three
    optimizers' count, mu and nu, the EMA critic and ret_range within 1e-5,
    and the metrics. (Free-running parameters are not gated at 1e-5: adam's
    first step g / (|g| + eps) turns a gradient element near eps, 9.46e-9 in
    JAX and 7.95e-9 here of a leaf whose max|g| is 0.055, into steps that
    differ by 4% of lr, 3.6e-5 of the leaf's max|ref|.)"""
    pt_l = _pt_learner()
    pt_l.draw_noise = lambda b, length: jax_run["noise1"]
    ref = jax_run["update1"]
    metrics, own = _fed_update(pt_l, jax_run["batches"][0], ref["picks"], ref["grads"])
    for name, got, want in zip(("wm", "actor", "critic"), (own["wm"], own["actor"],
                                                           own["critic"]), ref["grads"]):
        _assert_tree_close(got, want, UPDATE_TOL, f"{name} gradients")
    _assert_state_close(pt_l.get_state(), jax_run["state1"], UPDATE_TOL, "update 1")
    want = jax_run["metrics1"]
    assert sorted(metrics) == sorted(want)
    for k in want:
        np.testing.assert_allclose(metrics[k], want[k], rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                   err_msg=k)
    assert all(t.device.type == "cpu" for t in pt_l._leaves + pt_l.st_world.mu)


def test_state_moves_from_jax_to_the_port(jax_run):
    """The JAX learner's state (params, critic_ema, optax chains, ret_range)
    loads into the port bit for bit; the port's next update lands where the
    JAX learner's does."""
    pt_l = _pt_learner()
    ref = jax_run["state1"]
    pt_l.set_state(_snap(ref))
    state = pt_l.get_state()
    _assert_tree_equal(state["params"], ref["params"], "params")
    _assert_tree_equal(state["critic_ema"], ref["critic_ema"], "critic_ema")
    for k in ("st_world", "st_actor", "st_critic"):
        (gc, gmu, gnu), (wc, wmu, wnu) = _adam_leaves(state[k]), _adam_leaves(ref[k])
        assert gc == wc == 1
        _assert_tree_equal(gmu, wmu, f"{k} mu")
        _assert_tree_equal(gnu, wnu, f"{k} nu")
    assert state["ret_range"] == float(ref["ret_range"])
    pt_l.draw_noise = lambda b, length: jax_run["noise2"]
    pt_l.update(jax_run["batches"][1])
    _assert_state_close(pt_l.get_state(), jax_run["state2"], MOVED_TOL, "update 2")


def test_state_moves_from_the_port_to_jax(jax_run):
    """The port's state after its update, as optax's trees, loads into the JAX
    learner, which updates from it where the port's learner does."""
    pt_l = _pt_learner()
    pt_l.set_state(jax_run["pt_state1"])
    pt_l.draw_noise = lambda b, length: jax_run["noise3"]
    metrics = pt_l.update(jax_run["batches"][1])
    _assert_state_close(pt_l.get_state(), jax_run["state3"], MOVED_TOL, "from the port")
    np.testing.assert_allclose(metrics["wm_loss"], jax_run["metrics3"]["wm_loss"],
                               rtol=MOVED_TOL)


def test_noise_comes_from_the_learners_own_generator():
    """The main path draws its Gumbel noise from a torch.Generator on the
    learner's device, seeded from the config: two learners agree, and
    successive updates draw new noise."""
    a, b = _pt_learner(), _pt_learner()
    na, nb = a.draw_noise(2, 3), b.draw_noise(2, 3)
    assert {k: v.shape for k, v in na.items()} == {
        "wm": (3, 2, 8, 8), "act": (15, 6, 2), "z": (15, 6, 8, 8)}
    for k in na:
        assert torch.equal(na[k], nb[k]) and torch.isfinite(na[k]).all()
    assert not torch.equal(a.draw_noise(2, 3)["wm"], na["wm"])


# ---- the runner and the algorithm -----------------------------------------------------

def test_act_np_matches_jax_act():
    """The runner's numpy step against the JAX runner's jitted act at the same
    params, state and Gumbel draws (from JAX's key: k1 for z, k2 for the
    action), exploring and greedy: h and z within 1e-6, the same actions."""
    jax_r = jax_dv3.DreamerV3EnvRunner(_configure(jax_dv3.DreamerV3Config()).env_runners(
        num_envs_per_env_runner=6), 0)
    pt_r = pt_dv3.DreamerV3EnvRunner(_configure(rllib.DreamerV3Config()).environment(
        chip_smoke.CartPole).env_runners(num_envs_per_env_runner=6), 0)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32), pt_r.params)
    n = 6
    h = rng.standard_normal((n, 128)).astype(np.float32)
    z = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (n, 8))].reshape(n, 64)
    pa = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    obs = 3 * rng.standard_normal((n, 4)).astype(np.float32)
    first = np.array([1, 0, 0, 1, 0, 0], np.float32)
    try:
        for seed, explore in ((5, True), (6, True), (7, False)):
            key = jax.random.PRNGKey(seed)
            k1, k2 = jax.random.split(key)
            gz = np.asarray(jax.random.gumbel(k1, (n, 8, 8)))
            ga = np.asarray(jax.random.gumbel(k2, (n, 2)))
            want = jax_r._act(params, h, z, pa, obs, first, key, explore)
            got = pt_r.act_np(params, h, z, pa, obs, first, gz, ga, explore)
            for g, w in zip(got[:2], want[:2]):
                assert g.dtype == np.float32
                err, _ = _leaf_err(g, w)
                assert err <= FWD_TOL, err
            np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    finally:
        jax_r.stop()
        pt_r.stop()


SMALL = dict(deter_size=32, hidden=32, embed_size=16, stoch_groups=4, stoch_classes=4,
             batch_size_seqs=4, seq_len=8, num_updates_per_iteration=3,
             sample_timesteps_per_iteration=100, num_steps_sampled_before_learning_starts=100,
             imag_horizon=5)


def _small_algo(monkeypatch=None):
    return (rllib.DreamerV3Config().environment(chip_smoke.CartPole)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                         rollout_fragment_length=50)
            .training(**SMALL).learners(device="cpu").debugging(seed=0).build_algo())


def test_dreamer_trains_on_the_cpu_and_restores(monkeypatch):
    """Three DreamerV3.train() iterations on chip_smoke's CartPole without
    gymnasium: finite losses, the updates the config asks for, the runner
    given the learner's weights; a checkpoint restores the learner bit for bit."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    algo = _small_algo()
    try:
        results = [algo.train() for _ in range(3)]
        learner = algo.learner_group.learners[0]
        assert learner.st_world.count == learner.st_actor.count == 3 * 3
        steps = [r["num_env_steps_sampled_lifetime"] for r in results]
        assert steps[0] >= 100 and steps[1] > steps[0] and steps[2] > steps[1]
        for r in results:
            for k in ("wm_loss", "actor_loss", "critic_loss", "kl_dyn", "ret_range"):
                assert np.isfinite(r[k]), k
        _assert_tree_equal(algo.env_runner_group.runners[0].params,
                           learner.get_weights(), "runner weights")
        state = algo.save_checkpoint()
        other = _small_algo()
        try:
            other.load_checkpoint(state)
            got = other.learner_group.get_state()
            _assert_tree_equal(got, state["learner"], "restored state")
            _assert_tree_equal(other.env_runner_group.runners[0].params,
                               state["learner"]["params"], "restored runner")
        finally:
            other.stop()
    finally:
        algo.stop()


def test_entry_points_refuse_a_silent_cpu(monkeypatch):
    """Without CUDA the card's default raises before any env is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []

    class Env(chip_smoke.CartPole):
        def __init__(self, config=None):
            built.append(1)
            super().__init__(config)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        rllib.DreamerV3Config().environment(Env).build_algo()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rllib.DreamerV3Learner(rllib.DreamerV3Config(), pt_module.RLModuleSpec(
            observation_space=OBS_SPACE, action_space=ACT_SPACE))
    assert not built
