"""Port parity: the paged KV layout, the prefix cache and chunked prefill
(ray_tpu_torch/llm/paged.py and the engine's paged path) against the JAX
package, in f32 on byte-tiny.

The JAX side is its jitted paged functions, called directly and compiled once
for the module: one prefill bucket, one install width, one decode step, one
fused burst, one suffix prefill and one chunk. The paged engine as a whole is
held to the port's slot engine and to a greedy loop over those same JAX
functions; no JAX engine is started. The engine scenarios mirror
tests/test_paged_kv.py.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import paged as jax_paged
from ray_tpu.models import config as jax_config
from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import config as pt_llm_config
from ray_tpu_torch.llm import model_runner as pt_runner
from ray_tpu_torch.llm import paged as pt_paged
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # logits and computed KV: f32 on both sides, summation orders differ
CFG = jax_config.get_config("byte-tiny")
PT_CFG = pt_config.get_config("byte-tiny")
SLOTS, BS, MAX_LEN, NUM_BLOCKS, BUCKET = 2, 16, 64, 8, 16
PROMPTS = {0: [1, 7, 42, 99, 5, 6, 200, 3, 11], 1: [1, 3, 3, 300, 9]}
INSTALL_AT = {0: 5, 1: 2}  # the block each prompt is installed into
GROW = (0, 1, 7)  # (slot, table index, block): slot 0's second block
BURST, STEPS_LEFT = 4, [4, 2]
LONG = [int(t) for t in np.random.default_rng(3).integers(3, 500, 40)]  # three chunks
CHUNK = 16
SUFFIX = LONG[BS:BS + 14]  # after the first block of LONG, cached at PREFIX_BLOCK
PREFIX_BLOCK = 3
ENGINE_PROMPTS = [[1, 10, 20, 30], [1, 99, 98, 97, 96, 95, 94], [1, 200, 201]]
GREEDY_TOKENS = 9


def _padded(prompt, width=BUCKET):
    tokens = np.zeros((1, width), np.int32)
    tokens[0, :len(prompt)] = prompt
    return tokens


def _np_state(st):
    return {n: np.array(getattr(st, n)) for n in ("k", "v", "block_tables", "lengths")}


def _jax_state(d):
    return jax_paged.PagedState(*(jnp.asarray(d[n]) for n in
                                  ("k", "v", "block_tables", "lengths")))


def _pt_state(d):
    return pt_paged.PagedState(
        k=torch.from_numpy(d["k"].copy()), v=torch.from_numpy(d["v"].copy()),
        block_tables=torch.from_numpy(d["block_tables"].astype(np.int64)),
        lengths=torch.from_numpy(d["lengths"].astype(np.int64)))


def _empty():
    return _np_state(jax_paged.init_paged_state(CFG, SLOTS, MAX_LEN, NUM_BLOCKS, BS))


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(jax_params):
    return bridge.params_from_jax(jax_params, PT_CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_out(jax_params):
    """Each stage's inputs and results of the JAX paged functions. The
    functions donate their state, so every call gets a fresh copy and each
    stage is kept as numpy."""
    out = {"empty": _empty()}
    st = out["empty"]
    for slot, prompt in PROMPTS.items():
        k, v, last = jax_runner.prefill_detached(
            jax_params, jnp.asarray(_padded(prompt)), jnp.int32(len(prompt)), CFG)
        out[f"prefill{slot}"] = dict(k=np.array(k), v=np.array(v), logits=np.array(last))
        st = _np_state(jax_paged.install_prefill(
            _jax_state(st), k, v, jnp.asarray([INSTALL_AT[slot]], jnp.int32),
            jnp.int32(len(prompt)), jnp.int32(slot), n_blocks=1))
    out["install"] = st
    slot, index, block = GROW
    st = _np_state(jax_paged.append_block(_jax_state(st), jnp.int32(slot), jnp.int32(index),
                                          jnp.int32(block)))
    out["append"] = st

    def step(stage, st, tokens, active):
        new, logits = jax_paged.decode_step_paged(
            jax_params, _jax_state(st), jnp.asarray(tokens, jnp.int32), jnp.asarray(active),
            CFG)
        out[stage] = dict(_np_state(new), logits=np.asarray(logits), before=st,
                          tokens=tokens, active=active)
        return out[stage]

    step("decode_step", out["append"], [17, 250], [True, True])
    # slot 1 inactive with a stale table that points at slot 0's block: its
    # write must land in the scratch block, not in slot 0's KV
    stale = dict(out["decode_step"])
    stale = {n: stale[n].copy() for n in ("k", "v", "block_tables", "lengths")}
    stale["block_tables"][1, 0] = INSTALL_AT[0]
    step("decode_inactive", stale, [33, 44], [True, False])
    first = np.argmax(out["decode_step"]["logits"], axis=-1).astype(np.int32)
    new, toks = jax_paged.decode_multi_paged(
        jax_params, _jax_state(out["decode_step"]), jnp.asarray(first), jnp.asarray([True, True]),
        CFG, jax.random.split(jax.random.PRNGKey(1), BURST), jnp.zeros((SLOTS,), jnp.float32),
        jnp.ones((SLOTS,), jnp.float32), jnp.zeros((SLOTS,), jnp.int32),
        jnp.asarray(STEPS_LEFT, jnp.int32))
    out["burst"] = dict(_np_state(new), tokens=np.asarray(toks), first=first)
    k, v, last = jax_paged.chunked_prefill(jax_params, LONG, CFG, CHUNK)
    out["chunked"] = dict(k=np.asarray(k), v=np.asarray(v), logits=np.asarray(last))
    # the prefix cache: LONG's first block (as chunked prefill computed it)
    # sits at PREFIX_BLOCK; SUFFIX is prefilled over it
    pool = _empty()
    pool["k"][:, PREFIX_BLOCK] = out["chunked"]["k"][:, 0, :BS]
    pool["v"][:, PREFIX_BLOCK] = out["chunked"]["v"][:, 0, :BS]
    k, v, last = jax_paged.prefill_suffix_from_state(
        jax_params, _jax_state(pool), jnp.asarray([PREFIX_BLOCK], jnp.int32),
        jnp.asarray(_padded(SUFFIX)), jnp.int32(len(SUFFIX)), CFG, n_blocks=1)
    out["suffix"] = dict(pool=pool, k=np.array(k), v=np.array(v), logits=np.array(last))
    return out


@pytest.fixture(scope="module")
def jax_greedy(jax_params, jax_out):
    """Token ids of a greedy loop over the JAX paged functions (prefill,
    install, decode_step_paged), slot 0 with slot 1 idle, for ENGINE_PROMPTS
    (after jax_out: the same programs). Each fits its first block."""
    greedy = []
    for prompt in ENGINE_PROMPTS:
        k, v, last = jax_runner.prefill_detached(
            jax_params, jnp.asarray(_padded(prompt)), jnp.int32(len(prompt)), CFG)
        st = _np_state(jax_paged.install_prefill(
            _jax_state(_empty()), k, v, jnp.asarray([0], jnp.int32), jnp.int32(len(prompt)),
            jnp.int32(0), n_blocks=1))
        ids = [int(np.argmax(last))]
        while len(ids) < GREEDY_TOKENS:
            new, logits = jax_paged.decode_step_paged(
                jax_params, _jax_state(st), jnp.asarray([ids[-1], 0], jnp.int32),
                jnp.asarray([True, False]), CFG)
            st = _np_state(new)
            ids.append(int(np.argmax(np.asarray(logits)[0])))
        greedy.append(ids)
    return greedy


def _assert_pool(got, want, exact=False):
    tol = 0 if exact else TOL
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                                   rtol=tol, atol=tol)
    assert got.block_tables.tolist() == want["block_tables"].tolist()
    assert got.lengths.tolist() == want["lengths"].tolist()


def test_prefill_detached_matches_jax(jax_out, pt_params):
    for slot, prompt in PROMPTS.items():
        k, v, last = pt_runner.prefill_detached(
            pt_params, torch.from_numpy(_padded(prompt)).long(), len(prompt), PT_CFG)
        want = jax_out[f"prefill{slot}"]
        np.testing.assert_allclose(last.numpy(), want["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(k.numpy(), want["k"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(v.numpy(), want["v"], rtol=TOL, atol=TOL)


def test_install_prefill_and_append_block_match_jax(jax_out):
    """The same KV installed into the same blocks, then a block appended:
    pool, tables and lengths equal JAX's exactly."""
    st = _pt_state(jax_out["empty"])
    for slot, prompt in PROMPTS.items():
        pre = jax_out[f"prefill{slot}"]
        st = pt_paged.install_prefill(st, torch.from_numpy(pre["k"]), torch.from_numpy(pre["v"]),
                                      [INSTALL_AT[slot]], len(prompt), slot, 1)
    _assert_pool(st, jax_out["install"], exact=True)
    st = pt_paged.append_block(st, *GROW)
    _assert_pool(st, jax_out["append"], exact=True)


@pytest.mark.parametrize("stage", ["decode_step", "decode_inactive"])
def test_decode_step_paged_matches_jax(jax_out, pt_params, stage):
    """One paged decode step with both slots active, and one with slot 1
    inactive and its table pointing at slot 0's block: logits, pool (the
    scratch block included) and lengths agree with JAX."""
    want = jax_out[stage]
    st, logits = pt_paged.decode_step_paged(
        pt_params, _pt_state(want["before"]), torch.tensor(want["tokens"]),
        torch.tensor(want["active"]), PT_CFG)
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=TOL, atol=TOL)
    _assert_pool(st, want)
    if stage == "decode_inactive":  # slot 0's block holds what it held, but the new token
        before, after = want["before"]["k"][:, INSTALL_AT[0]], st.k[:, INSTALL_AT[0]].numpy()
        np.testing.assert_array_equal(np.delete(after, 10, axis=1), np.delete(before, 10, axis=1))


def test_decode_multi_paged_matches_jax(jax_out, pt_params):
    """A fused 4-step greedy burst with budgets of 4 and 2 steps: JAX's token
    ids, pool and lengths."""
    want = jax_out["burst"]
    st, toks = pt_paged.decode_multi_paged(
        pt_params, _pt_state(jax_out["decode_step"]), torch.from_numpy(want["first"]).long(),
        torch.tensor([True, True]), PT_CFG, BURST, torch.zeros(SLOTS), torch.ones(SLOTS),
        torch.zeros(SLOTS, dtype=torch.long), torch.tensor(STEPS_LEFT),
        torch.Generator().manual_seed(1))
    assert toks.tolist() == want["tokens"].tolist()
    _assert_pool(st, want)


def test_chunked_prefill_matches_jax(jax_out, pt_params):
    k, v, last = pt_paged.chunked_prefill(pt_params, LONG, PT_CFG, CHUNK, "cpu")
    want = jax_out["chunked"]
    assert k.shape[2] == 48
    for got, name in ((k, "k"), (v, "v"), (last, "logits")):
        np.testing.assert_allclose(got.numpy(), want[name], rtol=TOL, atol=TOL)


def test_prefill_suffix_from_state_matches_jax(jax_out, pt_params):
    """The suffix prefilled over a cached block: suffix KV and last logits
    agree with JAX, and the gathered context is a copy of the pool."""
    want = jax_out["suffix"]
    st = _pt_state(want["pool"])
    ctx_k, _ = pt_paged.gather_blocks(st, [PREFIX_BLOCK], 1)
    assert ctx_k.data_ptr() != st.k.data_ptr()
    np.testing.assert_array_equal(ctx_k[:, 0].numpy(), want["pool"]["k"][:, PREFIX_BLOCK])
    k, v, last = pt_paged.prefill_suffix_from_state(
        pt_params, st, [PREFIX_BLOCK], torch.from_numpy(_padded(SUFFIX)).long(), len(SUFFIX),
        PT_CFG, 1)
    for got, name in ((k, "k"), (v, "v"), (last, "logits")):
        np.testing.assert_allclose(got.numpy(), want[name], rtol=TOL, atol=TOL)


def test_install_with_prefix_matches_jax(jax_out):
    """Suffix KV into fresh blocks behind a cached one: the pool equals JAX's."""
    want = jax_out["suffix"]
    row = np.zeros((MAX_LEN // BS,), np.int32)
    row[:2] = [PREFIX_BLOCK, 6]
    n = BS + len(SUFFIX)
    jst = _np_state(jax_paged.install_with_prefix(
        _jax_state(want["pool"]), jnp.asarray(want["k"]), jnp.asarray(want["v"]),
        jnp.asarray([6], jnp.int32), jnp.asarray(row), jnp.int32(n), jnp.int32(1), n_new=1))
    st = pt_paged.install_with_prefix(_pt_state(want["pool"]), torch.from_numpy(want["k"]),
                                      torch.from_numpy(want["v"]), [6], row, n, 1, 1)
    _assert_pool(st, jst, exact=True)


def _manager_script(seed=0, steps=60):
    """A seeded run of admissions (match_prefix, allocate, register_blocks)
    and releases over a pool small enough to evict. Prompts share prefixes."""
    rng = np.random.default_rng(seed)
    bases = [list(rng.integers(3, 500, 24)) for _ in range(3)]
    ops = []
    for _ in range(steps):
        slot = int(rng.integers(0, 4))
        if rng.random() < 0.4:
            ops.append(("release", slot))
            continue
        base = bases[int(rng.integers(0, 3))]
        prompt = base[:int(rng.integers(4, 25))] + list(rng.integers(3, 500, int(rng.integers(0, 9))))
        ops.append(("admit", slot, [int(t) for t in prompt]))
    return ops


def _run_manager(bm, ops, bs=4):
    trace = []
    for op in ops:
        slot = op[1]
        if op[0] == "release" or bm.owned[slot]:
            bm.release(slot)
            trace.append(("release", slot, bm.num_free))
            if op[0] == "release":
                continue
        prompt = op[2]
        cached = bm.match_prefix(slot, prompt)
        bm.hit_tokens += len(cached) * bs
        need = bm.blocks_needed(len(prompt) + 1) - len(cached)
        new = bm.allocate(slot, need) if bm.can_allocate(need) else []
        bm.register_blocks(slot, prompt, cached + new, skip_blocks=len(cached))
        trace.append(("admit", slot, cached, new, bm.num_free, bm.hit_tokens,
                      sorted(bm.cached.values())))
    return trace


def test_block_manager_matches_jax():
    """The same seeded script through JAX's _BlockManager and the port's copy:
    block ids, hit tokens, free counts and cached blocks equal at every step,
    with evictions on the way."""
    ops = _manager_script()
    args = (12, 4, 8, 4)  # blocks, block size, blocks per slot, slots
    want = _run_manager(jax_paged.make_block_manager(*args), ops)
    got = _run_manager(pt_paged.make_block_manager(*args), ops)
    assert got == want
    assert any(t[0] == "admit" and t[2] for t in want)  # prefix hits happened
    assert any(t[0] == "admit" and not t[3] for t in want)  # and a full pool


# ------------------------------------------------------------------------ engine

@pytest.fixture
def fixed_gate(monkeypatch):
    """The pay-or-skip gate's floor at 1 token: every hit is taken,
    whatever the timings measured on this machine."""
    monkeypatch.setattr(pt_llm_config, "PREFIX_MIN_HIT_TOKENS", 1)


def _engine(pt_params, **kw):
    cfg = dict(model_id="paged", model_source="byte-tiny", max_num_seqs=4, max_model_len=128,
               dtype="float32")
    cfg.update(kw)
    return TorchLLMEngine(LLMConfig(**cfg), params=pt_params, device="cpu")


def _greedy(engine, prompt, n=8):
    return engine.generate_sync(prompt, SamplingParams(
        max_tokens=n, temperature=0.0, stop_token_ids=[-1])).token_ids


def _concurrently(fn, args):
    out = {}
    threads = [threading.Thread(target=lambda a=a: out.__setitem__(a, fn(a))) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "engine hung"
    return out


def test_paged_engine_matches_slot_engine_and_jax(pt_params, jax_greedy):
    """Three concurrent requests through the paged engine (fused 4-step
    bursts) give the slot engine's ids and the JAX paged loop's."""
    kw = dict(max_num_seqs=SLOTS, max_model_len=MAX_LEN, num_decode_steps=4)
    slot, paged = _engine(pt_params, **kw), _engine(pt_params, kv_layout="paged", **kw)
    try:
        idx = range(len(ENGINE_PROMPTS))
        got = _concurrently(lambda i: _greedy(paged, ENGINE_PROMPTS[i], GREEDY_TOKENS), idx)
        ref = _concurrently(lambda i: _greedy(slot, ENGINE_PROMPTS[i], GREEDY_TOKENS), idx)
    finally:
        slot.shutdown()
        paged.shutdown()
    assert [got[i] for i in idx] == [ref[i] for i in idx] == jax_greedy
    assert paged.metrics()["kv_blocks_free"] == paged.metrics()["kv_blocks_total"]


def test_preemption_recomputes_correctly(pt_params):
    """A pool of 6 blocks for 3 requests of 24 tokens: the youngest is
    preempted, prefilled again from its history, and every request gives the
    slot engine's ids; all blocks come back."""
    prompts = ("first request here", "second one", "third prompt x")
    ref = _engine(pt_params)
    eng = _engine(pt_params, kv_layout="paged", num_kv_blocks=6, kv_block_size=16)
    try:
        want = {p: _greedy(ref, p, 24) for p in prompts}
        got = _concurrently(lambda p: _greedy(eng, p, 24), prompts)
    finally:
        ref.shutdown()
        eng.shutdown()
    assert got == want
    m = eng.metrics()
    assert m["num_preemptions"] >= 1
    assert m["kv_blocks_total"] == 6 and m["kv_blocks_free"] == 6
    assert m["kv_pool_occupancy"] == 0.0


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_chunked_prefill_matches_whole_prompt(pt_params, layout):
    long_prompt = "word " * 40  # 201 tokens: four chunks of 64
    kw = dict(kv_layout=layout, max_num_seqs=2, max_model_len=256)
    whole, chunked = _engine(pt_params, **kw), _engine(pt_params, prefill_chunk=64, **kw)
    try:
        assert _greedy(whole, long_prompt) == _greedy(chunked, long_prompt)
    finally:
        whole.shutdown()
        chunked.shutdown()


def test_prefix_cache_reuses_blocks(pt_params, fixed_gate):
    """An identical prompt's two full blocks come from the cache, and the ids
    are unchanged and the slot engine's; prefixes shared with other
    suffixes are served from the cache too."""
    eng, ref = _engine(pt_params, kv_layout="paged"), _engine(pt_params)
    prompt = "x" * 40  # 41 tokens: two full blocks cacheable
    base = "shared prefix " * 3
    try:
        first = _greedy(eng, prompt)
        assert eng.metrics()["prefix_cache_hit_tokens"] == 0
        assert _greedy(eng, prompt) == first == _greedy(ref, prompt)
        m = eng.metrics()
        assert m["prefix_cache_hit_tokens"] == 32 and m["prefix_cached_blocks"] >= 2
        for tail in ("alpha", "beta gamma", "z"):
            assert _greedy(eng, base + tail) == _greedy(ref, base + tail), tail
        assert eng.metrics()["prefix_cache_hit_tokens"] >= 32 + 2 * 32
    finally:
        eng.shutdown()
        ref.shutdown()


def test_prefix_gate_skips_a_hit_too_small_to_pay(pt_params, monkeypatch):
    """With the floor above the largest possible hit, the cache is not used
    and each skip is counted."""
    monkeypatch.setattr(pt_llm_config, "PREFIX_MIN_HIT_TOKENS", 1000)
    eng = _engine(pt_params, kv_layout="paged")
    try:
        first = _greedy(eng, "x" * 40)
        assert _greedy(eng, "x" * 40) == first
    finally:
        eng.shutdown()
    m = eng.metrics()
    assert m["prefix_cache_hit_tokens"] == 0 and m["num_prefix_skipped"] == 2
    assert m["prefix_cached_blocks"] == 0


def test_prefix_cache_eviction_under_pressure(pt_params, fixed_gate):
    """Unreferenced cached blocks are reclaimed: a pool-filling request
    evicts them instead of failing."""
    eng = _engine(pt_params, kv_layout="paged", max_num_seqs=2, num_kv_blocks=10)
    try:
        _greedy(eng, "c" * 60)  # leaves 3 cached blocks at refcount 0
        assert eng.metrics()["prefix_cached_blocks"] == 3
        assert len(_greedy(eng, "d" * 100, n=16)) == 16  # needs 8 of the 10 blocks
    finally:
        eng.shutdown()
    # one of the three evicted; the new prompt's six full blocks published
    assert eng.metrics()["prefix_cached_blocks"] == 2 + 6


def test_prefix_cache_with_chunked_long_prompts(pt_params, fixed_gate):
    """A chunked long prompt seeds the cache; a sibling with a short new
    suffix takes the cached-context path and gives the slot engine's ids."""
    kw = dict(max_num_seqs=2, max_model_len=256)
    eng = _engine(pt_params, kv_layout="paged", prefill_chunk=64, **kw)
    ref = _engine(pt_params, **kw)
    base = "common system preamble " * 6  # 139 tokens: chunked
    try:
        assert _greedy(eng, base + "one") == _greedy(ref, base + "one")
        assert eng.metrics()["prefix_cache_hit_tokens"] == 0
        assert _greedy(eng, base + "two!") == _greedy(ref, base + "two!")
        assert eng.metrics()["prefix_cache_hit_tokens"] == 128
    finally:
        eng.shutdown()
        ref.shutdown()
