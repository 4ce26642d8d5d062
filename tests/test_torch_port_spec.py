"""Port parity: n-gram speculative decoding (ray_tpu_torch/llm/model_runner.py,
llm/paged.py and the engine's speculative steps) against the JAX package, in
f32 on byte-tiny.

The JAX side is its jitted functions, called directly and compiled once for
the module: the on-device n-gram proposer, one verify window per layout (its
logits taken from spec_driver's layer seam) and the fused burst per layout
through the n-gram proposer and through the propose_fn seam. The engines are
held to the port's plain greedy engine; no JAX engine is started.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import paged as jax_paged
from ray_tpu.llm.config import SpecConfig as JaxSpecConfig
from ray_tpu.models import config as jax_config
from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.llm import LLMConfig, SamplingParams, SpecConfig, TorchLLMEngine
from ray_tpu_torch.llm import model_runner as pt_runner
from ray_tpu_torch.llm import paged as pt_paged
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # logits and KV: f32 on both sides, summation orders differ
CFG = jax_config.get_config("byte-tiny")
PT_CFG = pt_config.get_config("byte-tiny")
SLOTS, MAX_LEN, BS = 3, 32, 16
# slot 0's window of 4 crosses max_len (positions 29..32), slot 1's crosses
# the block boundary at 16 (14..17); slot 2 is inactive, its paged table
# pointing at slot 0's last block
LENGTHS, ACTIVE = [29, 14, 6], [True, True, False]
TABLES = np.asarray([[4, 1], [0, 5], [1, 3]])
K_VERIFY = 3
M, K_MULTI, NMAX = 3, 2, 3
MULTI_LENGTHS = [12, 20, 6]  # room for M * (K_MULTI + 1) = 9 positions
NEG = dict(temperature=0.0, stop_token_ids=[-1])


def _np_state(st, paged):
    names = ("k", "v", "block_tables", "lengths") if paged else ("k", "v", "lengths")
    return {n: np.array(getattr(st, n)) for n in names}


def _jax_state(d):
    if "block_tables" in d:
        return jax_paged.PagedState(*(jnp.asarray(d[n]) for n in
                                      ("k", "v", "block_tables", "lengths")))
    return jax_runner.DecodeState(*(jnp.asarray(d[n]) for n in ("k", "v", "lengths")))


def _pt_state(d):
    k, v = torch.from_numpy(d["k"].copy()), torch.from_numpy(d["v"].copy())
    lengths = torch.from_numpy(d["lengths"].astype(np.int64))
    if "block_tables" in d:
        return pt_paged.PagedState(k, v, torch.from_numpy(d["block_tables"].astype(np.int64)),
                                   lengths)
    return pt_runner.DecodeState(k, v, lengths)


def _states(lengths):
    """Seeded random KV for 3 slots (f32), as a slot state and as the same KV
    laid out in blocks by TABLES (numpy dicts)."""
    rng = np.random.default_rng(5)
    shape = (CFG.n_layers, SLOTS, MAX_LEN, CFG.n_kv_heads, CFG.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    slot = dict(k=k, v=v, lengths=np.asarray(lengths, np.int32))
    pk = np.zeros((CFG.n_layers, 7, BS) + shape[3:], np.float32)
    pv = np.zeros_like(pk)
    for s in range(2):  # the inactive slot owns nothing
        for j, blk in enumerate(TABLES[s]):
            pk[:, blk], pv[:, blk] = k[:, s, j * BS:(j + 1) * BS], v[:, s, j * BS:(j + 1) * BS]
    tables = TABLES.copy()
    tables[2, 0] = TABLES[0, 1]  # stale: slot 0's block
    paged = dict(k=pk, v=pv, block_tables=tables.astype(np.int32),
                 lengths=np.asarray(lengths, np.int32))
    return slot, paged


def _sampling(n=SLOTS):
    return (np.zeros((n,), np.float32), np.ones((n,), np.float32), np.zeros((n,), np.int32))


def _pt_sampling(n=SLOTS):
    return torch.zeros(n), torch.ones(n), torch.zeros(n, dtype=torch.long)


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(jax_params):
    return bridge.params_from_jax(jax_params, PT_CFG, device="cpu")


# ------------------------------------------------------------------ the proposer

def _histories():
    """[rows, 16] histories with their valid lengths, one case a row."""
    rng = np.random.default_rng(4)
    hist = rng.integers(3, 60, (8, 16)).astype(np.int32)
    hlen = np.full((8,), 12, np.int32)
    hist[0, :12] = [5, 6, 7, 8, 9, 5, 6, 7, 8, 2, 5, 6]  # trigram match, full drafts
    hist[1, :12] = [4, 1, 2, 4, 1, 3, 3, 9, 9, 9, 1, 4]  # longest n-gram absent, unigram hits
    hist[2, :12] = np.arange(30, 42)  # no match at all
    hlen[3], hist[3, :2] = 2, [7, 7]  # hlen < n: the tail's start clamps to 0
    hlen[4], hist[4, :1] = 1, [7]  # one token: nothing before the tail
    hlen[5] = 0  # empty history
    # the match's continuation reaches the tail: 3 drafts, fewer than k
    hist[6, :12] = [20, 21, 22, 23, 24, 25, 26, 1, 2, 3, 1, 2]
    # hlen at the width: the continuation starts at 13, past L - k = 12, so
    # the drafts come from the clamped slice start, as lax.dynamic_slice
    # reads them ([2, 13, 3] and not [13, 3, 2])
    hlen[7], hist[7] = 16, [9, 8, 7, 6, 5, 4, 30, 31, 32, 33, 34, 3, 2, 13, 3, 2]
    last = np.asarray([hist[i, max(n - 1, 0)] for i, n in enumerate(hlen)], np.int32)
    return hist, hlen, last


def test_propose_ngram_device_matches_jax():
    """Seeded histories and the edges of the start clamp: a tail longer than
    the history, drafts from near the end of the row, no match, and a
    continuation that reaches the tail."""
    hist, hlen, last = _histories()
    want_w, want_n = map(np.asarray, jax.jit(jax_runner.propose_ngram_device,
                                             static_argnums=(3, 4))(hist, hlen, last, 4, NMAX))
    got_w, got_n = pt_runner.propose_ngram_device(
        torch.from_numpy(hist).long(), torch.from_numpy(hlen).long(),
        torch.from_numpy(last).long(), 4, NMAX)
    assert got_n.tolist() == want_n.tolist() == [4, 4, 0, 1, 0, 0, 3, 3]
    assert got_w.tolist() == want_w.tolist()
    assert got_w[7].tolist() == [2, 2, 13, 3, 0]


# ------------------------------------------------------------- one verify window

def _jax_verify(paged):
    """JAX's spec_driver over _verify_block (or _verify_block_paged), with the
    window's logits recomputed from the hidden state its layer seam hands
    back (the same norm and head)."""

    def fn(params, st, window, draft_len, active, temperature, top_p, top_k):
        seen = {}

        def layers_pass(x):
            def body(h, xs):
                lp, a, b = xs
                if paged:
                    h, a, b = jax_paged._verify_block_paged(h, lp, CFG, a, b, st.block_tables,
                                                           st.lengths, active)
                else:
                    h, a, b = jax_runner._verify_block(h, lp, CFG, a, b, st.lengths,
                                                       active=active)
                return h, (a, b)

            x, (nk, nv) = jax.lax.scan(body, x, (params["layers"], st.k, st.v))
            seen["x"] = x
            return x, nk, nv

        nk, nv, lengths, toks, n_acc = jax_runner.spec_driver(
            params, st.k, st.v, st.lengths, window, draft_len, active, CFG,
            jax.random.PRNGKey(0), temperature, top_p, top_k, layers_pass=layers_pass)
        x = jax_llama.rms_norm(seen["x"], params["final_norm"], CFG.norm_eps)
        logits = jnp.einsum("sld,dv->slv", x, params["lm_head"]).astype(jnp.float32)
        return nk, nv, lengths, toks, n_acc, logits

    return jax.jit(fn)


@pytest.fixture(scope="module")
def jax_verify(jax_params):
    """Per layout: the window of each slot is [last, drafts...] where slot
    0's drafts are the model's own greedy picks (all accepted, the last two
    past max_len), slot 1's first draft is its greedy pick and the second is
    not (one accepted); slot 2 is inactive. The greedy picks come from
    earlier calls of the same function."""
    slot_state, paged_state = _states(LENGTHS)
    out = {}
    for layout, state in (("slot", slot_state), ("paged", paged_state)):
        fn = _jax_verify(layout == "paged")
        window = np.zeros((SLOTS, K_VERIFY + 1), np.int32)
        window[:, 0] = [17, 250, 3]
        draft_len = np.asarray([K_VERIFY, 2, 1], np.int32)
        args = (jnp.asarray(ACTIVE), *_sampling())
        for i in range(K_VERIFY):  # each pass fixes one more greedy draft of slot 0
            res = fn(jax_params, _jax_state(state), window, draft_len, *args)
            toks = np.asarray(res[3])
            window[0, i + 1] = toks[0, i]
            if i == 0:
                window[1, 1], window[1, 2] = toks[1, 0], (toks[1, 1] + 1) % CFG.vocab_size
        res = fn(jax_params, _jax_state(state), window, draft_len, *args)
        nk, nv, lengths, toks, n_acc, logits = map(np.asarray, res)
        out[layout] = dict(before=state, window=window, draft_len=draft_len, k=nk, v=nv,
                           lengths=lengths, toks=toks, n_acc=n_acc, logits=logits)
    return out


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_spec_verify_step_matches_jax(jax_verify, pt_params, layout):
    """Out tokens, n_acc and lengths equal JAX's; logits and the KV (the
    scratch block included) within 1e-5. The slot window past max_len drops
    its writes; the paged window writes into its second block; the inactive
    slot writes nothing the active slots own."""
    want = jax_verify[layout]
    fn = pt_runner.spec_verify_step if layout == "slot" else pt_paged.spec_verify_step_paged
    st, toks, n_acc, logits = fn(
        pt_params, _pt_state(want["before"]), torch.from_numpy(want["window"]).long(),
        torch.from_numpy(want["draft_len"]).long(), torch.tensor(ACTIVE), PT_CFG,
        *_pt_sampling(), torch.Generator().manual_seed(0), return_logits=True)
    assert n_acc.tolist() == want["n_acc"].tolist() == [K_VERIFY, 1, 0]
    assert toks.tolist() == want["toks"].tolist()
    assert st.lengths.tolist() == want["lengths"].tolist() == [33, 16, 6]
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.k.numpy(), want["k"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.v.numpy(), want["v"], rtol=TOL, atol=TOL)
    if layout == "slot":  # nothing written before the window, nor wrapped to position 0
        np.testing.assert_array_equal(st.k[:, :, :3].numpy(), want["before"]["k"][:, :, :3])


# --------------------------------------------------------------- the fused burst

def _continuation(pt_params, state, hist, hlen):
    """The port's greedy continuation (M * (K_MULTI + 1) tokens) of every
    slot from `state` and its history's last token: what an oracle drafts."""
    st = _pt_state(state)
    tok = torch.from_numpy(hist[np.arange(SLOTS), hlen - 1]).long()
    out = []
    for _ in range(M * (K_MULTI + 1)):
        st, logits = pt_runner.decode_step(pt_params, st, tok, torch.ones(SLOTS, dtype=torch.bool),
                                           PT_CFG)
        tok = logits.argmax(-1)
        out.append(tok.numpy())
    return np.stack(out, 1)


def _oracle_table(hist, hlen, cont):
    table = np.zeros((SLOTS, MAX_LEN), np.int32)
    for s in range(SLOTS):
        table[s, :hlen[s]] = hist[s, :hlen[s]]
        table[s, hlen[s]:hlen[s] + cont.shape[1]] = cont[s]
    return table


def _jax_oracle(table):
    """bench_serve.py's device oracle: the k tokens after hlen in a table of
    known continuations (through spec_multi's propose_fn seam)."""
    def propose(h, hl, last, k, nmax):
        t = jnp.asarray(table)
        starts = jnp.clip(hl, 0, t.shape[1] - k)
        drafts = jax.vmap(lambda row, s: jax.lax.dynamic_slice(row, (s,), (k,)))(t, starts)
        win = jnp.zeros((t.shape[0], k + 1), jnp.int32).at[:, 0].set(last)
        return win.at[:, 1:].set(drafts), jnp.full((t.shape[0],), k, jnp.int32)

    return propose


def _pt_oracle(table):
    table = torch.from_numpy(table).long()

    def propose(h, hl, last, k, nmax):
        starts = hl.clamp(0, table.shape[1] - k)
        drafts = torch.gather(table, 1, starts[:, None] + torch.arange(k)[None, :])
        window = torch.cat([last[:, None].long(), drafts], dim=1)
        return window, torch.full((table.shape[0],), k, dtype=torch.long)

    return propose


@pytest.fixture(scope="module")
def multi_inputs(pt_params):
    """Histories of MULTI_LENGTHS tokens with a repeated trigram (so the
    n-gram proposer drafts), the states, and the oracle's table."""
    rng = np.random.default_rng(6)
    hist = rng.integers(3, 400, (SLOTS, MAX_LEN)).astype(np.int32)
    hist[:, 2:6] = hist[:, 9:13] = [7, 8, 9, 10]
    hlen = np.asarray(MULTI_LENGTHS, np.int32)
    hist[1, 17:20] = hist[1, 2:5]  # slot 1's tail repeats an earlier trigram
    slot_state, paged_state = _states(MULTI_LENGTHS)
    cont = _continuation(pt_params, slot_state, hist, hlen)
    return dict(hist=hist, hlen=hlen, slot=slot_state, paged=paged_state,
                table=_oracle_table(hist, hlen, cont))


# spec_multi_impl, the propose -> verify -> accept loop, is one function for
# both layouts: the seam is held in the slot layout only, which saves a JAX
# compile (the paged verify window has its own test above)
MULTI_CASES = [("slot", "ngram"), ("slot", "oracle"), ("paged", "ngram")]


@pytest.fixture(scope="module")
def jax_multi(jax_params, multi_inputs):
    """JAX's spec_multi and spec_multi_paged (m=3, k=2, greedy) for each of
    MULTI_CASES."""
    inp, out = multi_inputs, {}
    for layout, proposer in MULTI_CASES:
        fn = jax_runner.spec_multi if layout == "slot" else jax_paged.spec_multi_paged
        st, toks, acc, drafted = fn(
            jax_params, _jax_state(inp[layout]), jnp.asarray(inp["hist"]),
            jnp.asarray(inp["hlen"]), jnp.asarray(ACTIVE), CFG,
            jax.random.split(jax.random.PRNGKey(0), M), *_sampling(), m=M, k=K_MULTI,
            nmax=NMAX, propose_fn=_jax_oracle(inp["table"]) if proposer == "oracle" else None)
        out[layout, proposer] = dict(_np_state(st, layout == "paged"), toks=np.asarray(toks),
                                     acc=np.asarray(acc), drafted=np.asarray(drafted))
    return out


@pytest.mark.parametrize("layout,proposer", MULTI_CASES)
def test_spec_multi_matches_jax(jax_multi, multi_inputs, pt_params, layout, proposer):
    """Three fused windows of k = 2: token ids, accepted and drafted counts
    and lengths equal JAX's, the KV within 1e-5; the oracle's drafts are
    accepted, the n-gram proposer drafts where the history repeats."""
    inp, want = multi_inputs, jax_multi[layout, proposer]
    fn = pt_runner.spec_multi if layout == "slot" else pt_paged.spec_multi_paged
    st, toks, acc, drafted = fn(
        pt_params, _pt_state(inp[layout]), torch.from_numpy(inp["hist"]).long(),
        torch.from_numpy(inp["hlen"]).long(), torch.tensor(ACTIVE), PT_CFG, *_pt_sampling(),
        M, K_MULTI, NMAX, propose_fn=_pt_oracle(inp["table"]) if proposer == "oracle" else None,
        generator=torch.Generator().manual_seed(0))
    assert drafted.tolist() == want["drafted"].tolist()
    assert acc.tolist() == want["acc"].tolist()
    assert toks.tolist() == want["toks"].tolist()
    assert st.lengths.tolist() == want["lengths"].tolist()
    np.testing.assert_allclose(st.k.numpy(), want["k"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.v.numpy(), want["v"], rtol=TOL, atol=TOL)
    if proposer == "oracle":
        assert acc[:, :2].sum() == 2 * M * K_MULTI  # active slots accept every draft
    else:
        assert drafted[0, :2].min() > 0


# ------------------------------------------------------------------- the engine

REPEAT = [1] + [10, 20, 30, 40] * 6
RANDOM = [1] + [int(t) for t in np.random.default_rng(7).integers(3, 500, 20)]
GEN = 40


def _engine(pt_params, **kw):
    cfg = dict(model_source="byte-tiny", max_num_seqs=SLOTS, max_model_len=128,
               dtype="float32")
    cfg.update(kw)
    return TorchLLMEngine(LLMConfig(**cfg), params=pt_params, device="cpu")


def _serve(eng, requests):
    """Run (prompt, SamplingParams) requests concurrently; engine shut down."""
    got = [None] * len(requests)

    def run(i):
        got[i] = eng.generate_sync(*requests[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.shutdown()
    return got


@pytest.fixture(scope="module")
def plain_greedy(pt_params):
    """The plain (non-speculative) engine's greedy ids for both prompts."""
    got = _serve(_engine(pt_params), [(p, SamplingParams(max_tokens=GEN, **NEG))
                                      for p in (REPEAT, RANDOM)])
    return [g.token_ids for g in got]


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_spec_engine_greedy_equals_plain(plain_greedy, pt_params, layout, steps):
    """k = 2, single-window (steps 1) and fused (steps 4): a repetitive and a
    random greedy prompt give the plain engine's ids, with drafts accepted on
    the repetitive one; a sampled request alongside gets its max_tokens; the
    fused path ran; the pool is all free after."""
    kw = dict(kv_layout="paged", kv_block_size=BS) if layout == "paged" else {}
    eng = _engine(pt_params, num_speculative_tokens=2, num_decode_steps=steps, **kw)
    fused = []
    real = eng._step_decode_spec_fused
    eng._step_decode_spec_fused = lambda m: (fused.append(m), real(m))
    got = _serve(eng, [(REPEAT, SamplingParams(max_tokens=GEN, **NEG)),
                       (RANDOM, SamplingParams(max_tokens=GEN, **NEG)),
                       (RANDOM, SamplingParams(max_tokens=17, temperature=0.8,
                                                   stop_token_ids=[-1]))])
    assert [g.token_ids for g in got[:2]] == plain_greedy
    assert len(got[2].token_ids) == 17 and got[2].finish_reason == "length"
    m = eng.metrics()
    assert 0 < m["num_spec_accepted"] <= m["num_spec_drafted"]
    assert bool(fused) == (steps > 1) and all(x > 1 for x in fused)
    if layout == "paged":
        assert m["kv_blocks_free"] == m["kv_blocks_total"]


# ids past the vocabulary and below 0 after repeated tokens: the n-gram
# proposer copies them from the prompt into drafts
OOV_REPEAT = [[1] + [10, 20, 10**6, 40] * 6, [1] + [10, 20, -1, 40] * 6]
OOV_GEN = 24


@pytest.fixture(scope="module")
def plain_oov(pt_params):
    """The plain engine's greedy ids for OOV_REPEAT (its gather clamps as
    JAX's does: tests/test_torch_port_serving.py holds it to JAX)."""
    got = _serve(_engine(pt_params), [(p, SamplingParams(max_tokens=OOV_GEN, **NEG))
                                      for p in OOV_REPEAT])
    return [g.token_ids for g in got]


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_spec_engine_serves_out_of_vocab_drafts(plain_oov, pt_params, layout, steps,
                                                monkeypatch):
    """Drafts that copy an out-of-vocabulary prompt id reach a verify window
    (single-window: the host proposer; fused: the device one); the window's
    gather clamps it as JAX's does, the draft is rejected, and both requests
    give the plain engine's greedy ids."""
    oov_windows = []
    real = pt_runner._forward_window

    def spy(params, window, *args):
        if window.shape[1] > 1 and ((window < 0) | (window >= PT_CFG.vocab_size)).any():
            oov_windows.append(window.clone())
        return real(params, window, *args)

    monkeypatch.setattr(pt_runner, "_forward_window", spy)
    kw = dict(kv_layout="paged", kv_block_size=BS) if layout == "paged" else {}
    eng = _engine(pt_params, num_speculative_tokens=2, num_decode_steps=steps, **kw)
    got = _serve(eng, [(p, SamplingParams(max_tokens=OOV_GEN, **NEG)) for p in OOV_REPEAT])
    assert [g.token_ids for g in got] == plain_oov
    assert [g.finish_reason for g in got] == ["length"] * len(OOV_REPEAT)
    assert oov_windows


def test_spec_paged_engine_preempts_and_finishes(plain_greedy, pt_params):
    """A 6-block pool of 16 tokens under three 40-token generations: the
    youngest is preempted and prefilled again from its history, every request
    finishes with the plain engine's ids, and the pool is all free after."""
    eng = _engine(pt_params, num_speculative_tokens=2, num_decode_steps=4, kv_layout="paged",
                  kv_block_size=BS, num_kv_blocks=6)
    got = _serve(eng, [(p, SamplingParams(max_tokens=GEN, **NEG))
                       for p in (REPEAT, RANDOM, REPEAT)])
    assert [g.token_ids for g in got] == [plain_greedy[0], plain_greedy[1], plain_greedy[0]]
    m = eng.metrics()
    assert m["num_preemptions"] >= 1
    assert m["kv_blocks_free"] == m["kv_blocks_total"] == 6


# ------------------------------------------------------------------- the config

@pytest.mark.parametrize("spec", [None, "instance", {"num_tokens": 5, "ngram_max": 1}])
def test_spec_config_resolves_as_jax(spec):
    """A SpecConfig (or its dict form) overrides the three scalar fields, as
    the JAX config resolves them."""
    kw = dict(num_speculative_tokens=2, ngram_prompt_lookup_max=4)
    ours = dict(kw, speculative=SpecConfig(num_tokens=3, ngram_max=2) if spec == "instance"
                else spec)
    theirs = dict(kw, speculative=JaxSpecConfig(num_tokens=3, ngram_max=2)
                  if spec == "instance" else spec)
    fields = ("num_speculative_tokens", "speculative_method", "ngram_prompt_lookup_max")
    got, want = LLMConfig(**ours), JaxLLMConfig(**theirs)
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


@pytest.mark.parametrize("kw,err", [
    (dict(num_tokens=0), "num_tokens must be >= 1"),
    (dict(ngram_max=0), "ngram_max must be >= 1")])
def test_spec_config_rejects_what_jax_rejects(kw, err):
    for cls in (SpecConfig, JaxSpecConfig):
        with pytest.raises(ValueError, match=err):
            cls(**kw)


def test_only_the_ngram_proposer_is_served():
    """The JAX engine's check (ray_tpu/llm/engine.py:293-297), at construction."""
    with pytest.raises(NotImplementedError, match="only 'ngram'"):
        LLMConfig(num_speculative_tokens=2, speculative_method="eagle")
    with pytest.raises(NotImplementedError, match="only 'ngram'"):
        LLMConfig(speculative={"method": "eagle"})
