"""Port parity: the training slice (llama.loss_fn, ray_tpu_torch.train)
against the JAX package, in f32 on test-tiny.

The weights are a numpy tree in the JAX layout (tests/_torch_port_util.py),
bridged into the port. The port's attention runs attention_impl="flash": on
the CPU that is the FlashAttention autograd Function with the kernels' plain
versions inside, the structure the card runs; JAX runs "reference". The JAX
results are computed once for the module: one jitted value_and_grad of
loss_fn, three steps of one jitted make_train_step(donate=False), and one
jitted optax update of a small tree.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from ray_tpu.models import config as jax_config
from ray_tpu.models import llama as jax_llama
from ray_tpu.train import step as jax_step
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.models import llama as pt_llama
from ray_tpu_torch.train import optim as pt_optim
from ray_tpu_torch.train import step as pt_step

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

LOSS_TOL = 1e-5  # f32 on both sides; matmul summation orders differ
GRAD_TOL = 1e-4  # f32 gradients, |grad| up to ~1
PARAM_TOL = 1e-5  # params after Adam steps of lr <= 3e-3: differences are ulps of lr
SCHEDULE_RTOL = 1e-6  # both in f32; cos may differ by an ulp
CFG = jax_config.get_config("test-tiny", attention_impl="reference")
PT_CFG = pt_config.get_config("test-tiny", attention_impl="flash")
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
N_STEPS = 3


def _batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, CFG.vocab_size, (2, 33)).astype(np.int32)
    mask = (rng.random((2, 33)) > 0.2).astype(np.int32)
    seg = np.repeat(np.asarray([[0] * 12 + [1] * 21]), 2, axis=0).astype(np.int32)
    return {"tokens": tokens, "loss_mask": mask, "segment_ids": seg}


def _pt_batch():
    return {k: torch.from_numpy(v).long() for k, v in _batch().items()}


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG, seed=2)


@pytest.fixture(scope="module")
def jax_loss(jax_params):
    """loss_fn's value, metrics and gradients at jax_params."""
    fn = jax.jit(jax.value_and_grad(jax_llama.loss_fn, has_aux=True), static_argnums=2)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    (loss, aux), grads = fn(jax_params, batch, CFG)
    return jax.tree_util.tree_map(np.asarray, (loss, aux, grads))


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    """(params, metrics, opt_state) after each of N_STEPS jitted steps."""
    tx = jax_step.make_optimizer(**OPT)
    step = jax_step.make_train_step(CFG, tx, donate=False)
    state = jax_step.TrainState(jnp.zeros((), jnp.int32), jax_params, tx.init(jax_params))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = []
    for _ in range(N_STEPS):
        state, metrics = step(state, batch)
        out.append(jax.tree_util.tree_map(np.asarray, (state.params, metrics,
                                                       state.opt_state)))
    return out


def _pt_params(tree, cfg=PT_CFG):
    params = bridge.params_from_jax(tree, cfg, device="cpu")
    for p in pt_llama.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _assert_tree_close(got, want, tol, what):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(flat_got[path], leaf, rtol=tol, atol=tol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_loss_fn_and_grads_match_jax(jax_params, jax_loss, impl):
    """With loss_mask and segment_ids."""
    want_loss, want_aux, want_grads = jax_loss
    cfg = dataclasses.replace(PT_CFG, attention_impl=impl)
    params = _pt_params(jax_params, cfg)
    loss, aux = pt_llama.loss_fn(params, _pt_batch(), cfg)
    leaves = pt_llama.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_TOL, atol=LOSS_TOL)
    for name in ("loss", "ce_loss", "moe_aux_loss", "tokens"):
        np.testing.assert_allclose(aux[name].item(), want_aux[name], rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=name)
    got = bridge.params_to_numpy(pt_llama.tree_unflatten(params, list(grads)))
    _assert_tree_close(got, want_grads, GRAD_TOL, "grad")


def test_loss_fn_masks_and_counts_targets(jax_params):
    """tokens is Σ loss_mask[:, 1:]; an all-zero mask gives loss 0 over a
    denominator of 1 (not a NaN)."""
    params = _pt_params(jax_params)
    batch = _pt_batch()
    _, aux = pt_llama.loss_fn(params, batch, PT_CFG)
    assert aux["tokens"].item() == batch["loss_mask"][:, 1:].sum().item()
    assert aux["moe_aux_loss"].item() == 0.0
    batch["loss_mask"] = torch.zeros_like(batch["loss_mask"])
    loss, aux = pt_llama.loss_fn(params, batch, PT_CFG)
    assert loss.item() == 0.0 and aux["tokens"].item() == 1.0


def test_train_steps_match_jax(jax_params, jax_steps):
    """Three steps from the same params: loss, grad_norm and every param after
    each step. Step 1 has lr = 0 (warm-up from 0), so its params stay put."""
    tx = pt_step.make_optimizer(**OPT)
    params = _pt_params(jax_params)
    state = pt_step.TrainState(0, params, tx.init(pt_llama.tree_leaves(params)))
    step = pt_step.make_train_step(PT_CFG, tx, device="cpu")
    batch = _pt_batch()
    for i, (want_params, want_metrics, _) in enumerate(jax_steps):
        state, metrics = step(state, batch)
        assert state.step == i + 1 and state.opt_state.count == i + 1
        for name in ("loss", "ce_loss", "tokens", "grad_norm"):
            np.testing.assert_allclose(metrics[name].item(), want_metrics[name],
                                       rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"{i} {name}")
        _assert_tree_close(bridge.params_to_numpy(state.params), want_params, PARAM_TOL,
                           f"step {i + 1}")
    first = jax_steps[0][0]["embed"]
    np.testing.assert_array_equal(first, jax_params["embed"])  # lr = 0 at step 1


def test_train_step_from_bridged_mid_training_state(jax_steps):
    """JAX's params and optax state after step 2, bridged into the port: the
    port's step 3 lands where JAX's does."""
    params2, _, opt2 = jax_steps[1]
    params = _pt_params(params2)
    state = pt_step.TrainState(2, params, bridge.opt_state_from_jax(opt2, PT_CFG, "cpu"))
    tx = pt_step.make_optimizer(**OPT)
    state, metrics = pt_step.make_train_step(PT_CFG, tx, device="cpu")(state, _pt_batch())
    want_params, want_metrics, want_opt = jax_steps[2]
    np.testing.assert_allclose(metrics["loss"].item(), want_metrics["loss"], rtol=LOSS_TOL)
    _assert_tree_close(bridge.params_to_numpy(state.params), want_params, PARAM_TOL, "params")
    got_opt = bridge.opt_state_to_numpy(state.opt_state, state.params)
    assert got_opt["count"] == int(want_opt[1][0].count) == 3
    _assert_tree_close(got_opt["mu"], want_opt[1][0].mu, GRAD_TOL, "mu")
    _assert_tree_close(got_opt["nu"], want_opt[1][0].nu, GRAD_TOL, "nu")


def test_opt_state_bridge_round_trips(jax_steps):
    _, _, opt = jax_steps[-1]
    params = bridge.params_from_jax(jax_steps[-1][0], PT_CFG, device="cpu")
    state = bridge.opt_state_from_jax(opt, PT_CFG, "cpu")
    back = bridge.opt_state_to_numpy(state, params)
    assert back["count"] == N_STEPS
    for name in ("mu", "nu"):
        _assert_tree_close(back[name], getattr(opt[1][0], name), 0.0, name)
    bad = (opt[0], (opt[1][0], opt[1][1], optax.ScaleByScheduleState(count=np.int32(7))))
    with pytest.raises(ValueError, match="count"):
        bridge.opt_state_from_jax(bad, PT_CFG, "cpu")


def test_donate_updates_in_place_and_copy_does_not(jax_params):
    tx = pt_step.make_optimizer(**OPT)
    params = _pt_params(jax_params)
    state = pt_step.TrainState(2, params, tx.init(pt_llama.tree_leaves(params)))
    state = state._replace(opt_state=state.opt_state._replace(count=2))  # lr > 0
    before = params["embed"].detach().clone()
    kept, _ = pt_step.make_train_step(PT_CFG, tx, donate=False, device="cpu")(
        state, _pt_batch())
    assert torch.equal(params["embed"], before) and state.opt_state.mu[0].abs().sum() == 0
    assert kept.params["embed"] is not params["embed"]
    new, _ = pt_step.make_train_step(PT_CFG, tx, device="cpu")(state, _pt_batch())
    assert new.params["embed"] is params["embed"] and not torch.equal(params["embed"], before)
    assert torch.equal(new.params["embed"], kept.params["embed"])


@pytest.fixture(scope="module")
def jax_remat_grads(jax_params):
    """JAX's gradients of loss_fn under the dots and dots_no_batch policies,
    from one jitted call."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def run(p):
        return {policy: jax.grad(lambda q: jax_llama.loss_fn(
            q, batch, dataclasses.replace(CFG, remat_policy=policy))[0])(p)
            for policy in ("dots", "dots_no_batch")}

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jax_params))


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_full_and_none_give_the_same_grads(jax_params, jax_remat_grads, policy):
    """Every remat policy gives the gradients of none (through the flash
    Function), and the dots policies JAX's under the same policy."""
    grads = {}
    for pol in (policy, "none"):
        cfg = dataclasses.replace(PT_CFG, remat_policy=pol)
        params = _pt_params(jax_params, cfg)
        loss, _ = pt_llama.loss_fn(params, _pt_batch(), cfg)
        grads[pol] = torch.autograd.grad(loss, pt_llama.tree_leaves(params))
    for a, b in zip(grads[policy], grads["none"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    if policy in jax_remat_grads:
        got = bridge.params_to_numpy(pt_llama.tree_unflatten(params, list(grads[policy])))
        _assert_tree_close(got, jax_remat_grads[policy], GRAD_TOL, f"{policy} grad")


class _CountProducts(TorchDispatchMode):
    """Records the batch size of every mm / addmm / bmm dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.batches = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm,
                                   torch.ops.aten.bmm):
            self.batches.append(args[0].shape[0] if args[0].dim() == 3 else 0)
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_jax_recomputes(jax_params):
    """Counted on the reference attention path: the backward under full
    recomputes every product of the layers, dots none of them, dots_no_batch
    only the batched ones (attention's B*H products); the projections run as
    bmm of batch 1 and are saved. Early stop is off, so full recomputes the
    whole layer."""
    cfg0 = dataclasses.replace(PT_CFG, attention_impl="reference")
    backward, forward = {}, None
    for policy in ("none", "full", "dots", "dots_no_batch"):
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        params = _pt_params(jax_params, cfg)
        with set_checkpoint_early_stop(False):
            with _CountProducts() as fwd:
                loss, _ = pt_llama.loss_fn(params, _pt_batch(), cfg)
            with _CountProducts() as bwd:
                torch.autograd.grad(loss, pt_llama.tree_leaves(params))
        forward = fwd.batches[:-1]  # the layers' products; the last is the head's
        backward[policy] = bwd.batches
    recomputed = {p: sorted((Counter(backward[p]) - Counter(backward["none"])).elements())
                  for p in ("full", "dots", "dots_no_batch")}
    assert len(forward) == 9 * CFG.n_layers  # q k v, QK^T PV, o, gate up down
    assert recomputed["full"] == sorted(forward)
    assert recomputed["dots"] == []
    assert recomputed["dots_no_batch"] == sorted(b for b in forward if b > 1)
    assert len(recomputed["dots_no_batch"]) == 2 * CFG.n_layers


SCHEDULES = [(2, 10), (0, 5), (5, 3), (100, 10000)]  # (warmup_steps, total_steps)


def _schedule_steps(warmup, total):
    decay = max(total, warmup + 1)
    steps = np.arange(min(decay, 400) + 3)
    if decay > 400:  # the long schedule: its start and its end
        steps = np.concatenate([steps, np.arange(decay - 5, decay + 3)])
    return decay, steps


@pytest.fixture(scope="module")
def optax_schedules():
    def run():
        out = {}
        for warmup, total in SCHEDULES:
            decay, steps = _schedule_steps(warmup, total)
            sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
            out[warmup, total] = sched(jnp.asarray(steps, jnp.int32))
        return out

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)())


@pytest.mark.parametrize("warmup,total", SCHEDULES)
def test_schedule_matches_optax_at_every_step(optax_schedules, warmup, total):
    _, steps = _schedule_steps(warmup, total)
    sched = pt_step.make_optimizer(warmup_steps=warmup, total_steps=total).learning_rate
    got = np.asarray([sched(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, optax_schedules[warmup, total], rtol=SCHEDULE_RTOL,
                               atol=1e-12)
    assert got[0] == 0.0 or warmup == 0


# one clip + AdamW update of a small tree from a mid-training state (count 3,
# nonzero moments), with the gradient's global norm below and above grad_clip
UPDATE_CASES = [(mu, scale) for mu in ("float32", "bfloat16") for scale in (0.1, 10.0)]


def _update_inputs(scale):
    rng = np.random.default_rng(12)
    shapes = {"a": (3, 4), "b": (5,)}
    tree = lambda s=1.0: {k: (rng.standard_normal(v) * s).astype(np.float32)  # noqa: E731
                          for k, v in shapes.items()}
    params, grads, mu = tree(), tree(scale), tree(0.05)
    nu = {k: np.abs(v) * 0.01 for k, v in tree().items()}
    return params, grads, mu, nu


@pytest.fixture(scope="module")
def optax_updates():
    def run():
        out = {}
        for mu_dtype, scale in UPDATE_CASES:
            tx = jax_step.make_optimizer(learning_rate=0.1, warmup_steps=2,
                                         total_steps=20, mu_dtype=jnp.dtype(mu_dtype))
            params, grads, mu, nu = _update_inputs(scale)
            mu = jax.tree_util.tree_map(lambda x: jnp.asarray(x, mu_dtype), mu)
            state = (optax.EmptyState(), (
                optax.ScaleByAdamState(count=jnp.int32(3), mu=mu, nu=nu),
                optax.EmptyState(), optax.ScaleByScheduleState(count=jnp.int32(3))))
            updates, new = tx.update(grads, state, params)
            out[mu_dtype, scale] = (optax.apply_updates(params, updates), new[1][0].mu,
                                    new[1][0].nu, optax.global_norm(grads))
        return out

    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jax.jit(run)())


@pytest.mark.parametrize("mu_dtype,scale", UPDATE_CASES)
def test_clip_and_adamw_update_match_optax(optax_updates, mu_dtype, scale):
    params, grads, mu, nu = _update_inputs(scale)
    names = sorted(params)
    dt = pt_config.torch_dtype(mu_dtype)
    tx = pt_step.make_optimizer(learning_rate=0.1, warmup_steps=2, total_steps=20,
                                mu_dtype=mu_dtype)
    p = [torch.from_numpy(params[k]) for k in names]
    g = [torch.from_numpy(grads[k]) for k in names]
    state = pt_optim.AdamWState(3, [torch.from_numpy(mu[k]).to(dt) for k in names],
                                [torch.from_numpy(nu[k]) for k in names])
    new, norm = tx.update_(g, state, p)
    want_p, want_mu, want_nu, want_norm = optax_updates[mu_dtype, scale]
    assert (want_norm > tx.grad_clip) == (scale > 1)
    np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
    assert new.count == 4 and new.mu[0].dtype == dt
    # f32 agrees to rounding. With a bf16 mu, XLA rounds b1 * mu to bf16 or
    # keeps it in f32 depending on how it fuses the update (optax's jitted
    # update does not say which): the new mu may then differ by a bf16 ulp of
    # b1 * mu_old plus one of its own, and the params by that share of the
    # update, well inside 1 % of lr.
    p_tol = 1e-6 if mu_dtype == "float32" else 1e-2 * 0.1
    for i, k in enumerate(names):
        np.testing.assert_allclose(p[i].numpy(), want_p[k], rtol=p_tol, atol=p_tol, err_msg=k)
        got_mu = new.mu[i].float().numpy()
        if mu_dtype == "float32":
            np.testing.assert_allclose(got_mu, want_mu[k], rtol=1e-6, atol=1e-8, err_msg=k)
        else:
            bound = 2.0 ** -8 * (0.9 * np.abs(mu[k]) + np.abs(want_mu[k]))
            assert (np.abs(got_mu - want_mu[k]) <= bound).all(), k
        np.testing.assert_allclose(new.nu[i].numpy(), want_nu[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_clip_matches_optax_exactly_below_the_limit():
    """No epsilon: below the limit the gradients come back bit for bit."""
    g = [torch.full((4,), 0.1), torch.full((2,), -0.2)]
    before = [x.clone() for x in g]
    norm = pt_optim.clip_by_global_norm_(g, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(g, before))
    np.testing.assert_allclose(norm.item(), np.sqrt(4 * 0.01 + 2 * 0.04), rtol=1e-6)
