"""Port parity: sampling, the slot model runner, the engine and the server
(ray_tpu_torch.llm) against the JAX package on byte-tiny, in f32.

The JAX side is its jitted model runner, compiled once for the module: one
prefill bucket, one decode step and one fused burst. The slice as a whole is
held to a greedy loop over JAX prefill + decode_step on the same weights; the
JAX engine itself (which compiles every bucket) is not started.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu import knobs
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import sampling as jax_sampling
from ray_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from ray_tpu.models import config as jax_config
from ray_tpu_torch.llm import LLMConfig, LLMServer, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import config as pt_llm_config
from ray_tpu_torch.llm import model_runner as pt_runner
from ray_tpu_torch.llm import sampling as pt_sampling
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.ops import attention as pt_attn

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-4  # logits and KV: f32 on both sides, matmul summation orders differ
CFG = jax_config.get_config("byte-tiny")
PT_CFG = pt_config.get_config("byte-tiny")
SLOTS, MAX_LEN, BUCKET = 2, 32, 16  # one JAX compile each for prefill and decode
RUNNER_PROMPTS = {1: [1, 7, 42, 99, 5], 0: [1, 3, 3, 300, 9, 8, 7, 2, 11]}
ENGINE_PROMPTS = [[1, 10, 20, 30], [1, 99, 98, 97, 96, 95, 94], [1, 200, 201]]
OOV_PROMPTS = [[1, 10**6], [1, -1]]  # ids past the vocab and below 0: JAX's gather clamps
OOV_TOKENS = 4
GREEDY_TOKENS = 9
BURST, STEPS_LEFT = 4, [4, 2]
LOGITS = np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32)
TOP_K = np.asarray([0, 1, 5, 50], np.int32)
TOP_P = np.asarray([1.0, 0.3, 0.6, 0.95], np.float32)


def _padded(prompt):
    tokens = np.zeros((1, BUCKET), np.int32)
    tokens[0, :len(prompt)] = prompt
    return tokens


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(jax_params):
    return bridge.params_from_jax(jax_params, PT_CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_masks():
    """The JAX sampler's top-k and top-p masks, from one jitted call."""
    masks = jax.jit(lambda x, k, p: (jax_sampling._apply_top_k(x, k),
                                     jax_sampling._apply_top_p(x, p)))
    return dict(zip(("top_k", "top_p"), map(np.asarray, masks(LOGITS, TOP_K, TOP_P))))


@pytest.fixture(scope="module")
def jax_out(jax_params):
    """The JAX runner's results, computed once. The runner donates its state,
    so each stage's cache is copied out before the next call."""
    out = {}
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "ep", "tp"))
    st = jax_runner.init_state(CFG, SLOTS, MAX_LEN, mesh)

    def snap(stage, logits):
        out[stage] = dict(logits=np.asarray(logits), k=np.asarray(st.k), v=np.asarray(st.v),
                          lengths=np.asarray(st.lengths))

    lasts = []
    for slot, prompt in RUNNER_PROMPTS.items():
        st, last = jax_runner.prefill(jax_params, st, jnp.asarray(_padded(prompt)),
                                      jnp.int32(len(prompt)), jnp.int32(slot), CFG)
        lasts.append(np.asarray(last))
    snap("prefill", np.stack(lasts))
    active = jnp.asarray([True, True])
    st, logits = jax_runner.decode_step(jax_params, st, jnp.asarray([17, 250], jnp.int32),
                                        active, CFG)
    snap("decode_step", logits)
    return out


def _burst_in(jax_out):
    """The burst's first tokens: the greedy pick of the decode step."""
    return np.argmax(jax_out["decode_step"]["logits"], axis=-1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_burst(jax_params, jax_out):
    """The fused 4-step burst from the state the decode step left (its own
    fixture, so that no single test carries every compile)."""
    after = jax_out["decode_step"]
    st = jax_runner.DecodeState(*(jnp.asarray(after[n]) for n in ("k", "v", "lengths")))
    st, toks = jax_runner.decode_multi(
        jax_params, st, jnp.asarray(_burst_in(jax_out)), jnp.asarray([True, True]), CFG,
        jax.random.split(jax.random.PRNGKey(1), BURST), jnp.zeros((SLOTS,), jnp.float32),
        jnp.ones((SLOTS,), jnp.float32), jnp.zeros((SLOTS,), jnp.int32),
        jnp.asarray(STEPS_LEFT, jnp.int32))
    return dict(logits=np.asarray(toks), k=np.asarray(st.k), v=np.asarray(st.v),
                lengths=np.asarray(st.lengths))


@pytest.fixture(scope="module")
def jax_greedy(jax_params, jax_out):
    """Token ids of a greedy loop over JAX prefill + decode_step, slot 0 with
    the other slot idle (after jax_out, so its programs are compiled), for
    ENGINE_PROMPTS and then OOV_PROMPTS."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "ep", "tp"))
    st = jax_runner.init_state(CFG, SLOTS, MAX_LEN, mesh)
    greedy = []
    only0 = jnp.asarray([True, False])
    for prompt in ENGINE_PROMPTS + OOV_PROMPTS:
        st, last = jax_runner.prefill(jax_params, st, jnp.asarray(_padded(prompt)),
                                      jnp.int32(len(prompt)), jnp.int32(0), CFG)
        ids = [int(jnp.argmax(last))]
        while len(ids) < GREEDY_TOKENS:
            st, logits = jax_runner.decode_step(
                jax_params, st, jnp.asarray([ids[-1], 0], jnp.int32), only0, CFG)
            ids.append(int(jnp.argmax(logits[0])))
        greedy.append(ids)
    return greedy


@pytest.fixture(scope="module")
def pt_out(pt_params, jax_out):
    """The port's runner through the same stages (its state is updated in
    place, so each stage is cloned out)."""
    out = {}
    st = pt_runner.init_state(PT_CFG, SLOTS, MAX_LEN, "cpu")

    def snap(stage, logits):
        out[stage] = dict(logits=logits.numpy(), k=st.k.clone().numpy(),
                          v=st.v.clone().numpy(), lengths=st.lengths.clone().numpy())

    lasts = []
    for slot, prompt in RUNNER_PROMPTS.items():
        st, last = pt_runner.prefill(pt_params, st, torch.from_numpy(_padded(prompt)).long(),
                                     len(prompt), slot, PT_CFG)
        lasts.append(last)
    snap("prefill", torch.stack(lasts))
    active = torch.tensor([True, True])
    st, logits = pt_runner.decode_step(pt_params, st, torch.tensor([17, 250]), active, PT_CFG)
    snap("decode_step", logits)
    st, toks = pt_runner.decode_multi(
        pt_params, st, torch.from_numpy(_burst_in(jax_out)).long(), active, PT_CFG, BURST,
        torch.zeros(SLOTS), torch.ones(SLOTS), torch.zeros(SLOTS, dtype=torch.long),
        torch.tensor(STEPS_LEFT), torch.Generator().manual_seed(1))
    snap("decode_multi", toks)
    return out


def test_top_k_mask_matches_jax(jax_masks):
    got = pt_sampling._apply_top_k(torch.from_numpy(LOGITS), torch.from_numpy(TOP_K))
    np.testing.assert_array_equal(got.numpy(), jax_masks["top_k"])
    assert pt_sampling.NEG_INF == jax_sampling.NEG_INF


def test_top_p_mask_matches_jax(jax_masks):
    got = pt_sampling._apply_top_p(torch.from_numpy(LOGITS), torch.from_numpy(TOP_P))
    np.testing.assert_array_equal(got.numpy(), jax_masks["top_p"])


def test_sampler_greedy_rows_match_argmax():
    logits = torch.tensor([[1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    ones, zeros = torch.ones(2), torch.zeros(2, dtype=torch.long)
    hot = torch.full((2,), 5.0)
    # top_k=1, a tiny top_p, or temperature 0: the max token whatever the noise
    assert pt_sampling.sample(logits, hot, ones, torch.ones(2, dtype=torch.long),
                              gen).tolist() == [3, 0]
    assert pt_sampling.sample(logits, hot, torch.full((2,), 1e-6), zeros,
                              gen).tolist() == [3, 0]
    assert pt_sampling.sample(logits, torch.zeros(2), ones, zeros, gen).tolist() == [3, 0]


def test_sampler_draws_within_top_k_and_by_probability():
    """Sampled tokens match JAX only in distribution: with top_k=2 every draw
    is one of the two best tokens, in about their softmax proportion."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    n = len(logits)
    toks = pt_sampling.sample(logits, torch.ones(n), torch.ones(n),
                              torch.full((n,), 2, dtype=torch.long), gen)
    assert set(toks.tolist()) == {0, 1}
    share = (toks == 0).float().mean().item()
    assert abs(share - 1 / (1 + np.exp(-1.0))) < 0.03  # 0.731 +- 3 sigma


def _assert_same_state(got, want):
    np.testing.assert_allclose(got["k"], want["k"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["v"], want["v"], rtol=TOL, atol=TOL)
    assert got["lengths"].tolist() == want["lengths"].tolist()


@pytest.mark.parametrize("stage", ["prefill", "decode_step"])
def test_model_runner_matches_jax(jax_out, pt_out, stage):
    """Prefill into two slots, then one decode step: logits, KV and lengths
    agree with JAX after each stage."""
    want, got = jax_out[stage], pt_out[stage]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL, atol=TOL)
    _assert_same_state(got, want)


def test_model_runner_burst_matches_jax(jax_burst, pt_out):
    """A fused 4-step greedy burst with per-slot budgets (4 and 2 steps) gives
    JAX's [K, slots] token ids, KV and lengths."""
    got = pt_out["decode_multi"]
    assert got["logits"].tolist() == jax_burst["logits"].tolist()
    _assert_same_state(got, jax_burst)


def _engine(pt_params, **kw):
    cfg = dict(model_id="parity", model_source="byte-tiny", max_num_seqs=SLOTS,
               max_model_len=MAX_LEN, dtype="float32")
    cfg.update(kw)
    return TorchLLMEngine(LLMConfig(**cfg), params=pt_params, device="cpu")


def test_engine_greedy_tokens_match_jax_runner(jax_greedy, pt_params):
    """The slice as a whole: 3 concurrent requests over 2 slots, fused 4-step
    bursts, give the token ids of a greedy loop over JAX prefill+decode_step."""
    eng = _engine(pt_params, num_decode_steps=4)
    got = [None] * len(ENGINE_PROMPTS)

    def run(i):
        got[i] = eng.generate_sync(ENGINE_PROMPTS[i], SamplingParams(
            max_tokens=GREEDY_TOKENS, temperature=0.0, stop_token_ids=[-1])).token_ids

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(ENGINE_PROMPTS))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.shutdown()
    assert got == jax_greedy[:len(ENGINE_PROMPTS)]
    assert eng.num_prefills == len(ENGINE_PROMPTS)


def test_out_of_vocab_prompt_is_served_as_jax_serves_it(jax_greedy, pt_params):
    """Prompts holding an id past the vocabulary or below 0, admitted while a
    greedy request decodes in the other slot: the live request runs to its
    max_tokens, and each bad one gives the JAX runner's greedy ids (its
    gather clamps) instead of failing every request in flight."""
    eng = _engine(pt_params, max_model_len=64)
    greedy = dict(temperature=0.0, stop_token_ids=[-1])
    try:
        live = eng.generate([1, 5, 6], SamplingParams(max_tokens=40, **greedy))
        chunks = [next(live)]  # admitted: decoding while the bad prompts arrive
        bad = [eng.generate_sync(p, SamplingParams(max_tokens=OOV_TOKENS, **greedy))
               for p in OOV_PROMPTS]
        chunks += list(live)
    finally:
        eng.shutdown()
    assert chunks[-1].finish_reason == "length"
    assert sum(len(c.token_ids) for c in chunks) == 40
    assert [b.finish_reason for b in bad] == ["length"] * len(OOV_PROMPTS)
    want = [ids[:OOV_TOKENS] for ids in jax_greedy[len(ENGINE_PROMPTS):]]
    assert [b.token_ids for b in bad] == want


@pytest.fixture(scope="module")
def server(pt_params):
    srv = LLMServer(LLMConfig(model_id="tiny-srv", model_source="byte-tiny",
                              max_num_seqs=SLOTS, max_model_len=64, dtype="float32"),
                    engine=_engine(pt_params, max_model_len=64))
    try:
        yield srv
    finally:
        srv.shutdown()


def test_server_chat_returns_openai_envelope(server):
    resp = server.chat({"messages": [{"role": "user", "content": "hi"}],
                        "max_tokens": 4, "temperature": 0.0})
    assert resp["object"] == "chat.completion" and resp["model"] == "tiny-srv"
    assert resp["choices"][0]["message"]["role"] == "assistant"
    assert resp["choices"][0]["finish_reason"] in ("length", "stop")
    assert 1 <= resp["usage"]["completion_tokens"] <= 4
    assert resp["usage"]["total_tokens"] == (resp["usage"]["prompt_tokens"]
                                             + resp["usage"]["completion_tokens"])


def test_server_completions_returns_openai_envelope(server):
    resp = server.completions({"prompt": "abc", "max_tokens": 4, "model": "m"})
    assert resp["object"] == "text_completion" and resp["model"] == "m"
    assert isinstance(resp["choices"][0]["text"], str)
    assert resp["usage"]["prompt_tokens"] == 4  # bos + 3 bytes


@pytest.mark.parametrize("kind", ["chat", "completions"])
def test_server_streams_sse_frames(server, kind):
    body = {"max_tokens": 4, "stream": True, "temperature": 0.0}
    if kind == "chat":
        body["messages"] = [{"role": "user", "content": "hi"}]
    else:
        body["prompt"] = "abc"
    frames = list(getattr(server, kind)(body))
    assert frames[-1] == "data: [DONE]\n\n"
    chunks = [json.loads(f[len("data: "):]) for f in frames[:-1]]
    want_obj = "chat.completion.chunk" if kind == "chat" else "text_completion"
    assert all(c["object"] == want_obj for c in chunks)
    if kind == "chat":
        assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")


def test_abort_frees_the_slot(pt_params):
    """One slot: an aborted stream finishes with "abort" and the next request
    gets the slot (abort lands at a burst boundary, not at max_tokens)."""
    eng = _engine(pt_params, max_num_seqs=1, max_model_len=256)
    try:
        stream = eng.generate([1, 5, 6], SamplingParams(max_tokens=200, temperature=0.0,
                                                        stop_token_ids=[-1]),
                              request_id="long")
        assert next(stream).token_ids
        eng.abort("long")
        chunks = list(stream)
        assert chunks[-1].finish_reason == "abort"
        assert chunks[-1].num_generated_tokens < 200
        out = eng.generate_sync([1, 7], SamplingParams(max_tokens=3, temperature=0.0,
                                                       stop_token_ids=[-1]))
        assert len(out.token_ids) == 3 and out.finish_reason == "length"
    finally:
        eng.shutdown()


def test_loop_crash_fails_in_flight_requests_and_keeps_serving(pt_params, monkeypatch):
    """A prefill that raises finishes its request with "error"; the loop lives
    on and serves the next request."""
    eng = _engine(pt_params)
    real_prefill, calls = pt_runner.prefill, []

    def flaky_prefill(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected prefill failure")
        return real_prefill(*args, **kw)

    monkeypatch.setattr(pt_runner, "prefill", flaky_prefill)
    greedy = SamplingParams(max_tokens=2, temperature=0.0, stop_token_ids=[-1])
    try:
        assert eng.generate_sync([1, 4], greedy).finish_reason == "error"
        out = eng.generate_sync([1, 4], greedy)
        assert out.finish_reason == "length" and len(out.token_ids) == 2
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [dict(kv_layout="paged", data_parallel_size=2),
                                dict(expert_parallel_size=2),
                                dict(data_parallel_size=2), dict(tensor_parallel_size=2),
                                dict(kv_layout="paged", pipeline_parallel_size=2)])
def test_config_refuses_what_the_slice_does_not_serve(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        LLMConfig(**kw)


@pytest.mark.parametrize("kw,match", [
    (dict(kv_layout="paged", max_model_len=1000), "max_model_len must be a multiple of kv_block_size"),
    (dict(kv_layout="paged", prefill_buckets=[24, 1024]), "every prefill bucket"),
    (dict(kv_layout="paged", prefill_chunk=40), "prefill_chunk must be a multiple of kv_block_size"),
    (dict(kv_layout="paged", prefill_chunk=96), "max_model_len must be a multiple of prefill_chunk"),
    (dict(prefill_chunk=96), "max_model_len must be a multiple of prefill_chunk"),
    (dict(kv_layout="ring"), "unknown kv_layout")])
def test_config_rejects_what_the_jax_engine_rejects(kw, match):
    """The JAX engine's checks of the paged and chunked settings
    (ray_tpu/llm/engine.py:283-301), with its messages; the JAX config takes
    the same fields."""
    with pytest.raises(ValueError, match=match):
        LLMConfig(**kw)
    JaxLLMConfig(**{k: v for k, v in kw.items() if k != "kv_layout" or v != "ring"})


def test_config_takes_the_jax_paged_fields():
    """bench_serve.py's engine settings; and the defaults."""
    kw = dict(kv_layout="paged", kv_block_size=32, num_kv_blocks=100,
              enable_prefix_caching=False, prefill_chunk=256, max_model_len=1024,
              max_num_seqs=32, prefill_buckets=[32, 64, 128, 256, 512, 1024])
    ours, theirs = LLMConfig(**kw), JaxLLMConfig(**kw)
    assert [getattr(ours, k) for k in kw] == [getattr(theirs, k) for k in kw]
    assert ours.buckets() == theirs.buckets()
    fields = ("kv_layout", "kv_block_size", "num_kv_blocks", "enable_prefix_caching",
              "prefill_chunk")
    ours, theirs = LLMConfig(max_num_seqs=2), JaxLLMConfig(max_num_seqs=2)
    assert [getattr(ours, k) for k in fields] == [getattr(theirs, k) for k in fields]


@pytest.mark.parametrize("max_model_len", [64, 100, 1024])
def test_buckets_match_jax(max_model_len):
    want = JaxLLMConfig(max_num_seqs=2, max_model_len=max_model_len).buckets()
    assert LLMConfig(max_num_seqs=2, max_model_len=max_model_len).buckets() == want


def test_defaults_are_the_jax_knob_defaults():
    """The knob defaults the slice reads are constants in the port."""
    for env, const in [("RAY_TPU_LLM_MAX_NUM_SEQS", pt_llm_config.MAX_NUM_SEQS),
                       ("RAY_TPU_LLM_MAX_MODEL_LEN", pt_llm_config.MAX_MODEL_LEN),
                       ("RAY_TPU_LLM_FUSED_STEPS", pt_llm_config.FUSED_STEPS),
                       ("RAY_TPU_LLM_FUSED_STEPS_MAX", pt_llm_config.FUSED_STEPS_MAX),
                       ("RAY_TPU_LLM_FUSED_SYNC_TARGET", pt_llm_config.FUSED_SYNC_TARGET),
                       ("RAY_TPU_LLM_ENGINE_IDLE_WAIT_S", pt_llm_config.ENGINE_IDLE_WAIT_S),
                       ("RAY_TPU_LLM_PREFIX_MIN_HIT_TOKENS", pt_llm_config.PREFIX_MIN_HIT_TOKENS),
                       ("RAY_TPU_CHUNKED_ATTENTION_MIN_LOGITS", pt_attn.CHUNKED_MIN_LOGITS)]:
        assert knobs.get(env).default == const, env


def test_byte_tokenizer_matches_jax():
    text = "héllo, wörld ✓"
    ours, theirs = ByteTokenizer(), JaxByteTokenizer()
    assert ours.encode(text) == theirs.encode(text)
    ids = ours.encode(text) + [700, 0, 2]  # out-of-range and special ids are dropped
    assert ours.decode(ids) == theirs.decode(ids)
    assert (ours.eos_token_id, ours.vocab_size) == (theirs.eos_token_id, theirs.vocab_size)
