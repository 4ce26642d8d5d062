"""Port parity: the capacity-dispatch mixture-of-experts MLP
(ray_tpu_torch/models/moe.py) and every path that runs it, against the JAX
package, in f32 on moe-tiny.

moe_mlp with pads masked out, heavy overflow, several groups and top-1
gates; the model forward with and without a cache and its aux loss; the
loss and its gradients; slot and paged greedy decode with inactive slots,
the prefix-hit suffix prefill and chunked prefill; the verify window in
both layouts; int8 quantization and the bridge; the engine's streamed int8
start. The JAX side is its functions, jitted once for the module. Inactive
slots carry identical tokens and pads are identical ids, so both route
their picks to one expert past its capacity: a path that let them claim
capacity would drop real tokens' picks and disagree.
"""
import dataclasses
import functools
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import paged as jax_paged
from ray_tpu.models import config as jax_config
from ray_tpu.models import llama as jax_llama
from ray_tpu.models import moe as jax_moe
from ray_tpu.ops import quant as jax_quant
from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import model_runner as pt_runner
from ray_tpu_torch.llm import paged as pt_paged
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.models import llama as pt_llama
from ray_tpu_torch.models import moe as pt_moe
from ray_tpu_torch.ops import quant as pt_quant

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # f32 on both sides; summation orders differ
GRAD_TOL = 1e-4  # of max|ref| per leaf
CFG = jax_config.get_config("moe-tiny")
PT_CFG = pt_config.get_config("moe-tiny")
PROMPT = [1, 40, 41, 200, 7, 9]
SLOTS, MAX_LEN, BS, N_DECODE = 8, 48, 8, 3
REAL, JUNK = SLOTS - 1, 3  # the request's slot; the inactive slots' token
# moe_mlp cases: (config overrides, tokens, masked positions, group size)
MLP_CASES = {
    "masked": ({}, 24, [3, 10, 20, 21, 22, 23], None),
    "overflow": ({"moe_capacity_factor": 0.1}, 64, [], None),
    "groups": ({}, 20, [2, 17, 18, 19], 8),  # 4 groups of 5 (largest divisor <= 8)
    "top1": ({"moe_top_k": 1}, 16, [5], None),
    "top1_renorm": ({"moe_top_k": 1, "moe_top1_renorm": True}, 16, [5], None),
}


TIE_TOKENS = 16  # ROADMAP C2's input 1: router column 3 equal to column 0


def _tied_inputs(router):
    """16 seeded tokens and the router with column 3 a copy of column 0: each
    token's probabilities for experts 0 and 3 are equal."""
    x = np.random.default_rng(16).standard_normal((TIE_TOKENS, CFG.d_model)).astype(np.float32)
    router = np.array(router, copy=True)
    router[:, 3] = router[:, 0]
    return x, router


def _mlp_inputs(name):
    over, t, masked, _ = MLP_CASES[name]
    x = np.random.default_rng(len(name)).standard_normal((t, CFG.d_model)).astype(np.float32)
    mask = np.ones((t,), np.float32)
    mask[masked] = 0.0
    return over, x, mask


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def _padded(ids, width):
    out = np.zeros((1, width), np.int32)
    out[0, :len(ids)] = ids
    return out


def _sampling(n=SLOTS):
    return (np.zeros((n,), np.float32), np.ones((n,), np.float32), np.zeros((n,), np.int32))


def _pt(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(jax_params):
    return bridge.params_from_jax(jax_params, PT_CFG, device="cpu")


# ---------------------------------------------------------------- JAX results

def _window():
    """The verify window of the serving scenario: slot 6 (empty, active) and
    the request; the inactive slots' windows are JUNK."""
    window = np.full((SLOTS, 4), JUNK, np.int32)
    window[SLOTS - 2] = [5, 6, 7, 8]
    draft_len = np.zeros((SLOTS,), np.int32)
    draft_len[SLOTS - 2:] = [2, 3]
    active = np.zeros((SLOTS,), bool)
    active[SLOTS - 2:] = True
    return window, draft_len, active


def _jax_serve(params, paged):
    """Prefill PROMPT (bucket 8) into slot REAL, N_DECODE greedy decode
    steps with the other slots inactive, then one verify window whose
    window[REAL] is [last, last, first id, second id] (3 drafts)."""
    tokens = _padded(PROMPT, 8)
    if paged:
        nb = SLOTS * MAX_LEN // BS
        state = jax_paged.PagedState(
            k=jnp.zeros((CFG.n_layers, nb + 1, BS, CFG.n_kv_heads, CFG.head_dim)),
            v=jnp.zeros((CFG.n_layers, nb + 1, BS, CFG.n_kv_heads, CFG.head_dim)),
            block_tables=jnp.zeros((SLOTS, MAX_LEN // BS), jnp.int32),
            lengths=jnp.zeros((SLOTS,), jnp.int32))
        k, v, last = jax_runner.prefill_detached(params, tokens, len(PROMPT), CFG)
        state = jax_paged.install_prefill(state, k, v, jnp.asarray([3], jnp.int32),
                                          len(PROMPT), REAL, 1)
        state = jax_paged.append_block(state, REAL, 1, 4)
        state = jax_paged.append_block(state, SLOTS - 2, 0, 5)
        step = lambda st, toks, act: jax_paged.decode_step_paged(params, st, toks, act, CFG)
        verify = jax_paged.spec_verify_step_paged
    else:
        shape = (CFG.n_layers, SLOTS, MAX_LEN, CFG.n_kv_heads, CFG.head_dim)
        state = jax_runner.DecodeState(jnp.zeros(shape), jnp.zeros(shape),
                                       jnp.zeros((SLOTS,), jnp.int32))
        state, last = jax_runner.prefill(params, state, tokens, len(PROMPT), REAL, CFG)
        step = lambda st, toks, act: jax_runner.decode_step(params, st, toks, act, CFG)
        verify = jax_runner.spec_verify_step
    ids = [jnp.argmax(last)]
    active = jnp.arange(SLOTS) == REAL
    for _ in range(N_DECODE):
        toks = jnp.full((SLOTS,), JUNK, jnp.int32).at[REAL].set(ids[-1])
        state, logits = step(state, toks, active)
        ids.append(jnp.argmax(logits[REAL]))
    window, draft_len, vactive = _window()
    window = jnp.asarray(window).at[REAL].set(jnp.stack([ids[-1], ids[-1], ids[0], ids[1]]))
    before = state
    state, toks, n_acc = verify(params, state, window, jnp.asarray(draft_len),
                                jnp.asarray(vactive), CFG, jax.random.PRNGKey(0),
                                *_sampling())
    return dict(ids=jnp.stack(ids), window=window, before=before, after=state, toks=toks,
                n_acc=n_acc)


@pytest.fixture(scope="module")
def jax_out(jax_params):
    """Every JAX result of the module but chunked prefill, from one jitted
    call (chunked_prefill is a host loop over its own jitted chunk)."""

    def run(p):
        out = {}
        lp = jax.tree_util.tree_map(lambda a: a[0], p["layers"])
        for name, (over, t, masked, group) in MLP_CASES.items():
            cfg = dataclasses.replace(CFG, **over)
            _, x, mask = _mlp_inputs(name)
            with mock.patch.object(jax_moe, "_moe_group_size", lambda g=group: g or 4096):
                out[f"mlp_{name}"] = jax_moe.moe_mlp(x, lp["router"], lp["w_gate"], lp["w_up"],
                                                     lp["w_down"], cfg, mask=mask)
        x, _ = _tied_inputs(np.zeros((CFG.d_model, CFG.n_experts), np.float32))
        tied = lp["router"].at[:, 3].set(lp["router"][:, 0])
        out["mlp_tied"] = jax_moe.moe_mlp(jnp.asarray(x), tied, lp["w_gate"], lp["w_up"],
                                          lp["w_down"], CFG)
        tokens = jnp.asarray(_tokens(0, 2, 12))
        out["forward"] = jax_llama.forward(p, tokens, CFG, return_aux=True)[::2]
        cache = jax_llama.init_kv_cache(CFG, batch=2, max_len=16)
        for lo, hi in ((0, 5), (5, 8)):
            logits, cache, aux = jax_llama.forward(p, tokens[:, lo:hi], CFG, cache=cache,
                                                   return_aux=True)
            out[f"cached{hi}"] = (logits, aux, cache.k, cache.v)
        batch = {"tokens": jnp.asarray(_tokens(1, 2, 13))}
        out["loss"], out["grads"] = jax.value_and_grad(
            lambda q: jax_llama.loss_fn(q, batch, CFG)[0])(p)
        out["slot"] = _jax_serve(p, paged=False)
        out["paged"] = _jax_serve(p, paged=True)
        # the prefix hit: an 8-token cached context, a 3-token suffix padded to 32
        ck, cv, _ = jax_runner.prefill_detached(p, _padded(PROMPT + [11, 12], 8), 8, CFG)
        out["suffix"] = jax_paged._prefill_suffix_impl(p, ck, cv, _padded([13, 14, 15], 32),
                                                       3, CFG)
        out["int8"] = jax_quant.quantize_llama_params(p)
        out["int8_forward"] = jax_llama.forward(out["int8"], tokens, CFG)[0]
        return out

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(jax_params))
    out["chunked"] = tuple(map(np.asarray, jax_paged.chunked_prefill(
        jax_params, PROMPT + [50, 51, 52], CFG, 8)))
    return out


# ------------------------------------------------------------------- moe_mlp

@pytest.mark.parametrize("name", list(MLP_CASES))
def test_moe_mlp_matches_jax(jax_out, pt_params, name, monkeypatch):
    """Output and aux of one layer's experts on seeded tokens: pads masked
    out of capacity and aux, drops past a capacity of 4 (factor 0.1),
    groups of a divisor of T with the aux averaged, top-1 gates raw
    (Switch) and renormalised."""
    over, x, mask = _mlp_inputs(name)
    group = MLP_CASES[name][3]
    if group:
        monkeypatch.setattr(pt_moe, "MOE_GROUP_SIZE", group)
        assert pt_moe._group_size(x.shape[0]) == 5
    lp = pt_llama.layer_params(pt_params, 0)
    y, aux = pt_moe.moe_mlp(torch.from_numpy(x), lp["router"], lp["w_gate"], lp["w_up"],
                            lp["w_down"], dataclasses.replace(PT_CFG, **over),
                            mask=torch.from_numpy(mask))
    want_y, want_aux = jax_out[f"mlp_{name}"]
    np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=TOL, atol=TOL)
    if name == "overflow":  # the capacity really dropped picks, and JAX's same ones
        assert pt_moe.expert_capacity(dataclasses.replace(PT_CFG, **over), 64) == 4
    if name == "masked":  # a masked token gets nothing from the experts
        np.testing.assert_array_equal(y.numpy()[mask == 0], 0.0)


def test_tied_experts_route_as_jax_does(jax_out, pt_params):
    """ROADMAP C2: with router column 3 equal to column 0 every token ties
    experts 0 and 3; the port picks the lower index first, as
    jax.lax.top_k does, and agrees with JAX's moe_mlp to 1e-5 of max|y|."""
    lp = pt_llama.layer_params(pt_params, 0)
    x, router = _tied_inputs(lp["router"].numpy())
    y, aux = pt_moe.moe_mlp(torch.from_numpy(x), torch.from_numpy(router), lp["w_gate"],
                            lp["w_up"], lp["w_down"], PT_CFG)
    want_y, want_aux = jax_out["mlp_tied"]
    assert np.abs(y.numpy() - want_y).max() <= TOL * np.abs(want_y).max()
    np.testing.assert_allclose(aux.item(), want_aux, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_experts", [4, 8])
def test_top_k_takes_the_lower_index_first_among_ties(n_experts):
    """A row of equal probabilities picks experts 0 and 1; rows with planted
    ties pick what jax.lax.top_k picks, values and indices."""
    uniform = torch.full((1, n_experts), 1.0 / n_experts)
    vals, idx = pt_moe.top_k(uniform, 2)
    assert idx.tolist() == [[0, 1]] and vals.tolist() == uniform[:, :2].tolist()
    rng = np.random.default_rng(n_experts)
    probs = rng.integers(0, 4, (64, n_experts)).astype(np.float32) / 4  # many ties
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), 2)
    vals, idx = pt_moe.top_k(torch.from_numpy(probs), 2)
    assert idx.tolist() == np.asarray(want_idx).tolist()
    assert vals.tolist() == np.asarray(want_vals).tolist()


def test_capacity_and_group_size_follow_jax():
    for t in (1, 5, 8, 24, 100, 4096):
        for cf in (0.1, 1.25, 4.0):
            cfg = dataclasses.replace(CFG, moe_capacity_factor=cf)
            assert pt_moe.expert_capacity(dataclasses.replace(PT_CFG, moe_capacity_factor=cf),
                                          t) == jax_moe.expert_capacity(cfg, t)
    for t in (7, 4096, 4097, 12288, 8190):
        assert pt_moe._group_size(t) == jax_moe._group_size(t)


# ------------------------------------------------------------ forward and loss

def test_forward_and_aux_match_jax(jax_out, pt_params):
    tokens = torch.from_numpy(_tokens(0, 2, 12)).long()
    logits, _, aux = pt_llama.forward(pt_params, tokens, PT_CFG, return_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), jax_out["forward"][0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(aux.item(), jax_out["forward"][1], rtol=TOL, atol=TOL)
    assert aux.item() > 0.0  # summed over the layers, engaged
    cache = pt_llama.init_kv_cache(PT_CFG, batch=2, max_len=16, device="cpu")
    for lo, hi in ((0, 5), (5, 8)):
        logits, cache, aux = pt_llama.forward(pt_params, tokens[:, lo:hi], PT_CFG, cache=cache,
                                              return_aux=True)
        want = jax_out[f"cached{hi}"]
        np.testing.assert_allclose(logits.numpy(), want[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(aux.item(), want[1], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(cache.k.numpy(), want[2], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(cache.v.numpy(), want[3], rtol=TOL, atol=TOL)


def test_loss_and_gradients_match_jax(jax_out, jax_params):
    """loss_fn's value and every leaf's gradient (the router's through the
    gates and the aux loss) against jax.grad, at 1e-4 of max|ref|."""
    params = {k: ({n: t.requires_grad_() for n, t in v.items()} if isinstance(v, dict)
                  else v.requires_grad_())
              for k, v in bridge.params_from_jax(jax_params, PT_CFG, device="cpu").items()}
    loss, metrics = pt_llama.loss_fn(params, {"tokens": torch.from_numpy(
        _tokens(1, 2, 13)).long()}, PT_CFG)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_out["loss"], rtol=TOL, atol=TOL)
    assert metrics["moe_aux_loss"].item() > 0.0
    want = jax_out["grads"]
    for name in pt_llama.param_shapes(PT_CFG):
        pairs = ([(f"layers/{n}", params["layers"][n], want["layers"][n])
                  for n in params["layers"]] if name == "layers"
                 else [(name, params[name], want[name])])
        for where, p, g in pairs:
            scale = np.abs(g).max()
            assert scale > 0.0, where
            assert np.abs(p.grad.numpy() - g).max() <= GRAD_TOL * scale, where


# ------------------------------------------------------------------- serving

def _pt_serve(params, paged, bucket=8):
    """The port's counterpart of _jax_serve (the same steps, in place)."""
    tokens = _pt(_padded(PROMPT, bucket))
    if paged:
        state = pt_paged.init_paged_state(PT_CFG, SLOTS, MAX_LEN, SLOTS * MAX_LEN // BS, BS,
                                          device="cpu")
        k, v, last = pt_runner.prefill_detached(params, tokens, len(PROMPT), PT_CFG)
        nb = bucket // BS
        pt_paged.install_prefill(state, k, v, list(range(3, 3 + nb)), len(PROMPT), REAL, nb)
        pt_paged.append_block(state, REAL, nb, 4 if nb == 1 else 3 + nb)
        pt_paged.append_block(state, SLOTS - 2, 0, 5 if nb == 1 else 4 + nb)
        step = lambda st, toks, act: pt_paged.decode_step_paged(params, st, toks, act, PT_CFG)
        verify = pt_paged.spec_verify_step_paged
    else:
        state = pt_runner.init_state(PT_CFG, SLOTS, MAX_LEN, device="cpu")
        state, last = pt_runner.prefill(params, state, tokens, len(PROMPT), REAL, PT_CFG)
        step = lambda st, toks, act: pt_runner.decode_step(params, st, toks, act, PT_CFG)
        verify = pt_runner.spec_verify_step
    ids = [int(last.argmax())]
    active = torch.arange(SLOTS) == REAL
    for _ in range(N_DECODE):
        toks = torch.full((SLOTS,), JUNK, dtype=torch.long)
        toks[REAL] = ids[-1]
        state, logits = step(state, toks, active)
        ids.append(int(logits[REAL].argmax()))
    return ids, state, verify


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_greedy_decode_matches_jax_in_any_bucket(jax_out, pt_params, layout):
    """Prefill and greedy decode ids equal JAX's, with 7 inactive slots of
    one token beside the request; the prompt padded to 8 or to 32 gives the
    same ids (27 pads of one id, past the capacity of 21, claim nothing)."""
    want = jax_out[layout]["ids"].tolist()
    for bucket in (8, 32):
        ids, _, _ = _pt_serve(pt_params, layout == "paged", bucket)
        assert ids == want, bucket


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_verify_window_matches_jax(jax_out, pt_params, layout):
    """One verify window after the decode steps: 2 active slots, 6 inactive
    windows of one token (24 picks past a capacity of 21, masked), the
    S*W tokens routed as one group: out tokens, n_acc, lengths and the KV."""
    want = jax_out[layout]
    _, state, verify = _pt_serve(pt_params, layout == "paged")
    _, draft_len, active = _window()
    state, toks, n_acc = verify(pt_params, state, _pt(want["window"]), _pt(draft_len),
                                torch.from_numpy(active), PT_CFG,
                                *(_pt(a) for a in _sampling()))
    assert toks.tolist() == want["toks"].tolist()
    assert n_acc.tolist() == want["n_acc"].tolist()
    assert state.lengths.tolist() == want["after"].lengths.tolist()
    np.testing.assert_allclose(state.k.numpy(), want["after"].k, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state.v.numpy(), want["after"].v, rtol=TOL, atol=TOL)


def test_prefix_suffix_and_chunked_prefill_match_jax(jax_out, pt_params):
    """The prefix-hit suffix prefill (29 pads masked) and chunked prefill
    (the last chunk's pads masked): KV and last logits."""
    ck, cv, _ = pt_runner.prefill_detached(pt_params, _pt(_padded(PROMPT + [11, 12], 8)), 8,
                                           PT_CFG)
    got = pt_paged._prefill_suffix_impl(pt_params, ck, cv, _pt(_padded([13, 14, 15], 32)), 3,
                                        PT_CFG)
    chunked = pt_paged.chunked_prefill(pt_params, PROMPT + [50, 51, 52], PT_CFG, 8, device="cpu")
    for name, ours in (("suffix", got), ("chunked", chunked)):
        for a, b in zip(ours, jax_out[name]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)


# ----------------------------------------------------------------------- int8

def test_quantize_llama_params_on_experts_is_bit_equal_to_jax(jax_out, pt_params):
    """Expert stacks quantize per (layer, expert, output unit) over d_in, with
    scales [L, E, 1, out]; the router stays f32. The bridge carries JAX's
    int8 tree in and back out unchanged, and the port serves it as JAX does."""
    ours = pt_quant.quantize_llama_params(pt_params)
    bridged = bridge.params_from_jax(jax_out["int8"], PT_CFG, device="cpu")
    want = jax_out["int8"]
    e, d, f = CFG.n_experts, CFG.d_model, CFG.d_ff
    assert ours["layers"]["w_down"].s.shape == (CFG.n_layers, e, 1, d)
    assert ours["layers"]["w_gate"].s.shape == (CFG.n_layers, e, 1, f)
    assert not isinstance(ours["layers"]["router"], pt_quant.QTensor)
    for tree in (ours, bridged):
        back = bridge.params_to_numpy(tree)
        for name in pt_quant.LLAMA_QUANT_KEYS:
            for part in ("q", "s"):
                np.testing.assert_array_equal(getattr(back["layers"][name], part),
                                              getattr(want["layers"][name], part))
        np.testing.assert_array_equal(back["lm_head"].s, want["lm_head"].s)
        np.testing.assert_array_equal(back["layers"]["router"], want["layers"]["router"])
    logits, _ = pt_llama.forward(bridged, torch.from_numpy(_tokens(0, 2, 12)).long(), PT_CFG)
    np.testing.assert_allclose(logits.numpy(), jax_out["int8_forward"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", ["moe-tiny", "test-tiny"])
def test_engine_streamed_int8_start_is_quantized_init(model):
    """quantization="int8" with no params quantizes each layer as it draws
    it: bit for bit quantize_llama_params(init(cfg)), dense and MoE."""
    eng = TorchLLMEngine(LLMConfig(model_source=model, quantization="int8"), device="cpu")
    eng.start()
    cfg = eng.model_config
    want = pt_quant.quantize_llama_params(pt_llama.init(cfg, seed=0, device="cpu",
                                                        dtype=torch.bfloat16))
    got = eng.params
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for a, b in zip(pt_llama.tree_leaves(got), pt_llama.tree_leaves(want)):
        for x, y in (zip(a, b) if isinstance(a, pt_quant.QTensor) else [(a, b)]):
            assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------- engine

ENGINE_CASES = {
    "slot_fused4": dict(num_decode_steps=4),
    "paged": dict(kv_layout="paged", kv_block_size=BS, num_decode_steps=1),
    "slot_spec": dict(num_speculative_tokens=3, num_decode_steps=1),
    "paged_spec_fused2": dict(kv_layout="paged", kv_block_size=BS, num_speculative_tokens=3,
                              num_decode_steps=2),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_serves_moe_as_the_jax_runner(jax_out, pt_params, case, monkeypatch):
    """The slice as a whole: an engine of 2 slots serves PROMPT in either
    layout, with fused bursts or speculation, with the JAX runner's greedy
    ids. Without speculation a copying prompt runs beside it (2 tokens a
    step cannot overflow a capacity of 4). With it, PROMPT runs alone and
    the drafts are the JAX ids themselves (an oracle, through the host
    proposer and spec_multi's propose_fn seam), so every verify window
    accepts and routes real drafts; a random model's n-gram proposal would
    draft nothing here."""
    want = jax_out["slot"]["ids"].tolist()
    eng = TorchLLMEngine(LLMConfig(model_source="moe-tiny", max_num_seqs=2, max_model_len=32,
                                   dtype="float32", **ENGINE_CASES[case]),
                         params=pt_params, device="cpu")
    prompts = [PROMPT, [1, 10, 11, 12, 13, 10, 11, 12, 13]]
    if "spec" in case:
        prompts = prompts[:1]
        eng._propose_ngram = lambda req, cap: want[len(req.token_history) - len(PROMPT):][:cap]
        table = torch.zeros((2, 32), dtype=torch.long)
        table[:, :len(PROMPT) + len(want)] = torch.tensor(PROMPT + want)

        def oracle(h, hl, last, k, nmax):
            idx = hl.clamp(0, table.shape[1] - k)[:, None] + torch.arange(k)[None, :]
            return (torch.cat([last[:, None].long(), torch.gather(table, 1, idx)], dim=1),
                    torch.full((h.shape[0],), k, dtype=torch.long))

        monkeypatch.setattr(pt_paged, "spec_multi_paged", functools.partial(
            pt_paged.spec_multi_paged, propose_fn=oracle))
    got = [None] * len(prompts)

    def run(i):
        got[i] = eng.generate_sync(prompts[i], SamplingParams(
            max_tokens=N_DECODE + 1, temperature=0.0, stop_token_ids=[-1])).token_ids

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.shutdown()
    assert got[0] == want
    assert all(len(ids) == N_DECODE + 1 for ids in got)
    if "spec" in case:
        assert eng.num_spec_accepted == eng.num_spec_drafted > 0
