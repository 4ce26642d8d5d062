"""Port parity: P/D disaggregation on the host path (TorchLLMEngine.prefill_only,
generate_from_prefill and paged.trim_kv_for_transfer) against the JAX package
and the colocated port engine, in f32 on byte-tiny.

The JAX side is its functions, compiled once for the module: one
prefill_detached bucket, install_kv and one decode step; the greedy loop
over them is the reference. No JAX engine and no cluster are started. The
engine scenarios mirror tests/test_pd_disagg.py and the paged admission of
ray_tpu/llm/engine.py:1115-1142,1195-1219,1365-1370.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import paged as jax_paged
from ray_tpu.models import config as jax_config
from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import paged as pt_paged
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # logits and computed KV: f32 on both sides, summation orders differ
CFG = jax_config.get_config("byte-tiny")
PT_CFG = pt_config.get_config("byte-tiny")
SLOTS, MAX_LEN, BUCKET = 2, 64, 16
PAGED_BS = 4  # a 16-token bucket trims to 2 blocks for a 5-token prompt
PROMPTS = [[1, 7, 42, 99, 5], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [1, 50, 51]]
GREEDY_TOKENS = 7
GREEDY = dict(temperature=0.0, stop_token_ids=[-1])


def _padded(prompt, width=BUCKET):
    tokens = np.zeros((1, width), np.int32)
    tokens[0, :len(prompt)] = prompt
    return tokens


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(jax_params):
    return bridge.params_from_jax(jax_params, PT_CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_out(jax_params):
    """Per prompt: JAX prefill_detached's KV and first greedy token, then the
    greedy ids of that KV installed into slot 0 (install_kv) and decoded
    with decode_step, the other slot idle."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "ep", "tp"))
    out = []
    for prompt in PROMPTS:
        n = len(prompt)
        k, v, last = jax_runner.prefill_detached(jax_params, jnp.asarray(_padded(prompt)),
                                                 jnp.int32(n), CFG)
        k, v = np.asarray(k), np.asarray(v)
        st = jax_runner.install_kv(jax_runner.init_state(CFG, SLOTS, MAX_LEN, mesh),
                                   jnp.asarray(k), jnp.asarray(v), jnp.int32(n), jnp.int32(0))
        ids = [int(np.argmax(np.asarray(last)))]
        while len(ids) < GREEDY_TOKENS:
            st, logits = jax_runner.decode_step(
                jax_params, st, jnp.asarray([ids[-1], 0], jnp.int32),
                jnp.asarray([True, False]), CFG)
            ids.append(int(np.argmax(np.asarray(logits)[0])))
        out.append(dict(k=k, v=v, ids=ids))
    return out


def _engine(pt_params, layout="slot", **kw):
    cfg = dict(model_id="pd", model_source="byte-tiny", max_num_seqs=SLOTS,
               max_model_len=MAX_LEN, dtype="float32", kv_layout=layout)
    if layout == "paged":
        cfg["kv_block_size"] = PAGED_BS
    cfg.update(kw)
    return TorchLLMEngine(LLMConfig(**cfg), params=pt_params, device="cpu")


def _sampling(n=GREEDY_TOKENS):
    return SamplingParams(max_tokens=n, **GREEDY)


def _ids(stream):
    return [t for out in stream for t in out.token_ids]


def _concurrently(fn, n):
    out = [None] * n
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, fn(i))) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "engine hung"
    return out


@pytest.fixture
def engines(pt_params):
    made = []

    def make(*args, **kw):
        made.append(_engine(pt_params, *args, **kw))
        return made[-1]

    try:
        yield make
    finally:
        for eng in made:
            eng.shutdown()


# ------------------------------------------------------------------ the trim

@pytest.mark.parametrize("n_tokens,block_size,s_pad", [
    (1, 4, 16), (5, 4, 16), (7, 4, 16), (8, 4, 16), (15, 4, 16), (16, 4, 32), (33, 4, 64),
    (1, 16, 16), (15, 16, 16), (16, 16, 32), (31, 16, 32), (40, 16, 64), (40, 8, 64),
    (100, 16, 128), (3, 32, 16)])
def test_trim_kv_for_transfer_matches_jax(n_tokens, block_size, s_pad):
    """The smallest power-of-two block count covering n + 1 tokens, never
    past the padded length: the same rows as JAX's."""
    kv = np.arange(2 * s_pad * 3, dtype=np.float32).reshape(2, 1, s_pad, 3, 1)
    want_k, want_v = jax_paged.trim_kv_for_transfer(kv, kv + 1, n_tokens, block_size)
    got_k, got_v = pt_paged.trim_kv_for_transfer(torch.from_numpy(kv), torch.from_numpy(kv + 1),
                                                 n_tokens, block_size)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


# -------------------------------------------------------------- prefill_only

@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_prefill_only_matches_jax(jax_out, engines, layout):
    """k, v and the first token against JAX's prefill_detached + (paged)
    trim_kv_for_transfer + argmax; CPU tensors, no decode state."""
    eng = engines(layout)
    for prompt, want in zip(PROMPTS, jax_out):
        got = eng.prefill_only(prompt, _sampling())
        k, v = want["k"], want["v"]
        if layout == "paged":
            k, v = jax_paged.trim_kv_for_transfer(k, v, len(prompt), PAGED_BS)
        assert got["prompt_ids"] == prompt and got["first_token"] == want["ids"][0]
        assert got["k"].device.type == "cpu" and got["k"].shape == k.shape
        np.testing.assert_allclose(got["k"].numpy(), k, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["v"].numpy(), v, rtol=TOL, atol=TOL)
    assert eng.state is None and eng._loop_thread is None  # weights and nothing else
    if layout == "paged":
        assert got["k"].shape[2] == PAGED_BS  # 3 tokens' 16-token bucket trimmed


def test_prefill_only_first_text_follows_jax_rules(engines):
    """first_text renders the first token unless it is a stop token or a
    partial UTF-8 codepoint (the router then relays the decode stream)."""
    eng = engines()
    tok = eng.prefill_only(PROMPTS[0], _sampling())["first_token"]
    assert "first_text" not in eng.prefill_only(
        PROMPTS[0], SamplingParams(max_tokens=4, temperature=0.0, stop_token_ids=[tok]))
    eng.tokenizer.decode = lambda ids: "�"  # a lone lead byte
    assert "first_text" not in eng.prefill_only(PROMPTS[0], _sampling())
    eng.tokenizer.decode = lambda ids: "a"
    assert eng.prefill_only(PROMPTS[0], _sampling())["first_text"] == "a"


# --------------------------------------------------------------- P/D decode

@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_pd_greedy_matches_colocated_and_jax(jax_out, engines, layout):
    """Three concurrent P/D requests over two decode slots give the colocated
    engine's greedy ids and the JAX runner's; the decode engine computes no
    prefill and ends with every block free."""
    prefill, decode, colo = engines(layout), engines(layout), engines(layout)
    n = len(PROMPTS)
    got = _concurrently(lambda i: _ids(decode.generate_from_prefill(
        prefill.prefill_only(PROMPTS[i], _sampling()), _sampling())), n)
    want = _concurrently(lambda i: colo.generate_sync(PROMPTS[i], _sampling()).token_ids, n)
    assert got == want == [o["ids"] for o in jax_out]
    m = decode.metrics()
    assert decode.num_prefills == 0 and prefill.num_prefills == n
    assert (m["num_pending"], m["num_active"], m["total_generated"]) == (
        0, 0, n * GREEDY_TOKENS)
    assert m["pd_exports_live"] == 0
    if layout == "paged":
        assert m["kv_blocks_free"] == m["kv_blocks_total"]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_jax_kv_as_numpy_decodes_to_jax_ids(jax_out, engines, layout):
    """The KV of JAX's prefill_detached, fed as f32 numpy arrays with its
    first token, decodes on the port to the JAX runner's ids."""
    decode = engines(layout)
    for prompt, want in zip(PROMPTS, jax_out):
        result = {"prompt_ids": prompt, "first_token": want["ids"][0],
                  "k": want["k"], "v": want["v"]}
        assert _ids(decode.generate_from_prefill(result, _sampling())) == want["ids"]


def test_full_pool_requeues_a_transfer_until_a_release(engines):
    """A paged pool of 5 blocks, 4 or 5 of them held by a live request: a
    transfer needing 2 waits in the queue with its KV, and is served after
    the live request releases its blocks."""
    prefill, decode = engines("paged"), engines("paged", num_kv_blocks=5)
    colo = engines("paged")
    refusals = []
    live = decode.generate(PROMPTS[0], _sampling(12))
    first = [next(live)]  # admitted: its 16-token bucket holds 4 blocks
    can = decode._blocks.can_allocate
    decode._blocks.can_allocate = lambda n: refusals.append(not can(n)) or can(n)
    pre = prefill.prefill_only(PROMPTS[0], _sampling())
    assert pre["k"].shape[2] == 2 * PAGED_BS
    got = _ids(decode.generate_from_prefill(pre, _sampling()))
    rest = _ids(first + list(live))
    assert any(refusals), "the transfer was never refused a block"
    assert got == colo.generate_sync(PROMPTS[0], _sampling()).token_ids
    assert rest == colo.generate_sync(PROMPTS[0], _sampling(12)).token_ids
    m = decode.metrics()
    assert m["kv_blocks_free"] == 5 and m["num_pending"] == 0 and m["num_active"] == 0


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_transfer_wider_than_a_slot_fails_only_its_request(engines, layout):
    """KV from a prefill engine with a longer bucket and max_model_len than
    the decode engine's slots: that request finishes with "length" and no
    tokens, while a live request runs on to its max_tokens."""
    prefill = engines(layout, max_model_len=128, kv_block_size=16)
    decode = engines(layout, max_model_len=32, kv_block_size=16)
    pre = prefill.prefill_only(list(range(1, 41)), _sampling())
    assert pre["k"].shape[2] == 64
    live = decode.generate(PROMPTS[0], _sampling(12))
    chunks = [next(live)]
    failed = list(decode.generate_from_prefill(pre, _sampling()))
    chunks += list(live)
    assert [(o.finish_reason, o.token_ids) for o in failed] == [("length", [])]
    assert chunks[-1].finish_reason == "length" and len(_ids(chunks)) == 12
    assert decode.metrics()["num_pending"] == 0


def test_preempted_transfer_is_prefilled_again_from_its_history(engines):
    """Two P/D requests that outgrow a paged pool of 8 blocks: the youngest
    is preempted and prefilled again on the decode engine from its token
    history, and both give the colocated engine's ids."""
    prefill, decode, colo = engines("paged"), engines("paged", num_kv_blocks=8), engines("paged")
    prompts = PROMPTS[:2]
    got = _concurrently(lambda i: _ids(decode.generate_from_prefill(
        prefill.prefill_only(prompts[i], _sampling(20)), _sampling(20))), 2)
    assert got == [colo.generate_sync(p, _sampling(20)).token_ids for p in prompts]
    m = decode.metrics()
    assert m["num_preemptions"] >= 1 and decode.num_prefills >= 1
    assert m["kv_blocks_free"] == 8


def test_a_device_plane_handle_raises_naming_a10(engines):
    """The device-plane handoff is not ported: a kv_handle result raises at
    the call, before any state is allocated, instead of taking another path."""
    decode = engines()
    with pytest.raises(NotImplementedError, match="A10"):
        decode.generate_from_prefill({"prompt_ids": [1], "first_token": 3,
                                      "kv_handle": object(), "kv_key": "00"}, _sampling())
    assert decode._loop_thread is None
    decode.release_prefill_export("00ff")  # the host path pins nothing to release
    assert decode.metrics()["pd_exports_live"] == 0
