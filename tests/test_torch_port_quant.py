"""Port parity: weight-only int8 (W8A16, ray_tpu_torch/ops/quant.py) and the
serving path on int8 weights, against the JAX package on byte-tiny.

quantize and dequant must be the jitted JAX module's bit for bit; the model
runner on int8 weights is held to JAX's on the same JAX-quantized weights
(slot and paged decode, f32), and the int8 engine to a greedy loop over the
JAX functions. The JAX side is compiled once for the module; no JAX engine
is started.
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
from ray_tpu.ops import quant as jax_quant
from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import model_runner as pt_runner
from ray_tpu_torch.llm import paged as pt_paged
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.ops import quant as pt_quant

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # logits: f32 on both sides from the same int8 weights
CFG = jax_config.get_config("byte-tiny")  # untied lm_head
PT_CFG = pt_config.get_config("byte-tiny")
SLOTS, MAX_LEN, BUCKET, BS = 2, 32, 16, 16
PROMPTS = {0: [1, 7, 42, 99, 5, 6, 7, 42], 1: [1, 3, 3, 300, 9]}
ENGINE_PROMPTS = [[1, 10, 20, 30], [1, 99, 98, 97, 96, 95, 94]]
GREEDY_TOKENS = 8
PAGED_TABLES = np.asarray([[2, 0], [1, 0]])  # slot -> pool blocks (the 3rd, 4th unused)


def _bits(a):
    """An array's bits, to compare floats for bit equality."""
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _weights():
    """Seeded f32 weights [64, 8] contracted over axis 0 with three planted
    columns: amax 127 (scale exactly 1) with exact .5 ties, all zeros, and
    amax 127 * 2 with ties at 2 * (k + .5)."""
    w = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    ties = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    w[:, 0] = 0.25
    w[0, 0], w[1:9, 0] = 127.0, ties
    w[:, 1] = 0.0
    w[:, 2] = 0.5
    w[0, 2], w[1:9, 2] = -254.0, 2 * ties
    return w


@pytest.fixture(scope="module")
def jax_q():
    """JAX's quantize (jitted, as its engine runs it) of the planted weights
    and a stacked [L, d_in, out] one, with dequant in bf16 and f32."""
    w = _weights()
    stacked = np.random.default_rng(1).standard_normal((3, 16, 5)).astype(np.float32)
    quant = jax.jit(jax_quant.quantize, static_argnums=1)
    out = {"w": w, "stacked": stacked, "q": quant(w, 0), "q_stacked": quant(stacked, 1)}
    deq = jax.jit(lambda t: (jax_quant.dequant(t, jnp.bfloat16), jax_quant.dequant(t, jnp.float32)))
    # the bf16 result leaves the jit as bf16 and widens outside it (exact)
    out["bfloat16"], out["float32"] = (np.asarray(a).astype(np.float32) for a in deq(out["q"]))
    return out


@pytest.mark.parametrize("case,axis", [("w", 0), ("stacked", 1)])
def test_quantize_is_bit_equal_to_jax(jax_q, case, axis):
    """Half-way values round to even, an all-zero column gets the 1e-12
    floor, and the scales are JAX's to the bit."""
    got = pt_quant.quantize(torch.from_numpy(jax_q[case]), axis)
    want = jax_q["q" if case == "w" else "q_stacked"]
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(_bits(got.s.numpy()), _bits(want.s))
    if case == "w":  # the planted columns: ties to even, and the zero column
        assert got.q[1:9, 0].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
        assert got.q[:, 1].abs().max().item() == 0 and got.s[0, 1].item() == np.float32(1e-12)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequant_is_bit_equal_to_jax(jax_q, dtype):
    """q and s are each cast to the dtype before the product, as JAX does: in
    bf16 the scale is rounded first."""
    t = jax_q["q"]
    got = pt_quant.dequant(pt_quant.QTensor(torch.from_numpy(np.array(t.q)),
                                            torch.from_numpy(np.array(t.s))),
                           getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(jax_q[dtype]))


def test_as_weight_casts_a_plain_tensor():
    w = torch.randn(4, 3, dtype=torch.float64)
    assert pt_quant.as_weight(w, torch.float32).dtype == torch.float32


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def jax_qparams(jax_params):
    """JAX's quantize_llama_params (jitted, as its engine calls it), numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax_quant.quantize_llama_params)(
        jax_params))


@pytest.fixture(scope="module")
def pt_qparams(jax_qparams):
    """The JAX-quantized weights bridged to the port (int8 leaves as QTensors)."""
    return bridge.params_from_jax(jax_qparams, PT_CFG, device="cpu")


def test_quantize_llama_params_is_bit_equal_to_jax(jax_params, jax_qparams):
    """Every quantized leaf, the untied head included, and the untouched
    ones; then the bridge carries them back to the JAX layout."""
    ours = pt_quant.quantize_llama_params(bridge.params_from_jax(jax_params, PT_CFG,
                                                                 device="cpu"))
    assert isinstance(ours["lm_head"], pt_quant.QTensor)
    assert set(k for k, v in ours["layers"].items()
               if isinstance(v, pt_quant.QTensor)) == set(pt_quant.LLAMA_QUANT_KEYS)
    back = bridge.params_to_numpy(ours)
    flat_theirs = jax.tree_util.tree_leaves_with_path(jax_qparams)
    flat_ours = jax.tree_util.tree_leaves(back)
    assert len(flat_ours) == len(flat_theirs)
    for (path, want), got in zip(flat_theirs, flat_ours):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(_bits(got) if got.dtype != np.int8 else got,
                                      _bits(want) if want.dtype != np.int8 else want,
                                      err_msg=str(path))


def test_blockwise_and_numpy_formats_match_jax():
    """quantize_blockwise / dequant_blockwise (round to nearest) equal JAX's
    jitted pair; the numpy wire format equals JAX's numpy functions; a
    stochastic round lands on the floor or the ceiling of the scaled value."""
    x = np.random.default_rng(2).standard_normal((5, 700)).astype(np.float32)
    jq, js = jax.jit(jax_quant.quantize_blockwise, static_argnums=1)(x, 1024)
    jd = jax.jit(jax_quant.dequant_blockwise, static_argnums=(2, 3))(jq, js, x.size,
                                                                     jnp.float32)
    q, s = pt_quant.quantize_blockwise(torch.from_numpy(x), 1024)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    d = pt_quant.dequant_blockwise(q, s, x.size, torch.float32)
    np.testing.assert_array_equal(_bits(d.numpy()), _bits(jd))
    qs, ss = pt_quant.quantize_blockwise(torch.from_numpy(x), 1024,
                                         generator=torch.Generator().manual_seed(0))
    scaled = np.concatenate([x.reshape(-1), np.zeros(4 * 1024 - x.size, np.float32)]
                            ).reshape(4, 1024) / ss.numpy()
    assert np.all((qs.numpy() == np.floor(scaled)) | (qs.numpy() == np.ceil(scaled)))
    for block in (4096, 512):
        nq, ns = pt_quant.quantize_np(x, block)
        wq, ws = jax_quant.quantize_np(x, block)
        np.testing.assert_array_equal(nq, wq)
        np.testing.assert_array_equal(ns, ws)
        np.testing.assert_array_equal(pt_quant.dequant_np(nq, ns, block, np.float32),
                                      jax_quant.dequant_np(wq, ws, block, np.float32))
    assert pt_quant.quantize_np(np.zeros(0, np.float32))[0].size == 0


def _padded(prompt):
    tokens = np.zeros((1, BUCKET), np.int32)
    tokens[0, :len(prompt)] = prompt
    return tokens


def _paged_from_slots(k, v, lengths):
    """The slot cache [L, 2, 32, ...] as a pool of 4 blocks of 16 + scratch,
    laid out by PAGED_TABLES (numpy)."""
    pk = np.zeros((k.shape[0], 5, BS) + k.shape[3:], np.float32)
    pv = np.zeros_like(pk)
    for slot, row in enumerate(PAGED_TABLES):
        for j, blk in enumerate(row[:1]):  # each prompt fits its first block
            pk[:, blk] = k[:, slot, j * BS:(j + 1) * BS]
            pv[:, blk] = v[:, slot, j * BS:(j + 1) * BS]
    return dict(k=pk, v=pv, block_tables=PAGED_TABLES.astype(np.int32),
                lengths=np.asarray(lengths, np.int32))


@pytest.fixture(scope="module")
def jax_out(jax_qparams):
    """JAX's runner on its int8 weights: prefill into both slots, one slot
    decode step, and one paged decode step on the same KV; then a greedy loop
    per ENGINE_PROMPTS over prefill + decode_step."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "ep", "tp"))
    params = jax.tree_util.tree_map(jnp.asarray, jax_qparams,
                                    is_leaf=lambda x: isinstance(x, np.ndarray))
    st = jax_runner.init_state(CFG, SLOTS, MAX_LEN, mesh)
    lasts = []
    for slot, prompt in PROMPTS.items():
        st, last = jax_runner.prefill(params, st, jnp.asarray(_padded(prompt)),
                                      jnp.int32(len(prompt)), jnp.int32(slot), CFG)
        lasts.append(np.asarray(last))
    out = {"prefill": np.stack(lasts), "k": np.array(st.k), "v": np.array(st.v),
           "lengths": np.array(st.lengths)}
    tokens, active = jnp.asarray([17, 250], jnp.int32), jnp.asarray([True, True])
    pool = _paged_from_slots(out["k"], out["v"], out["lengths"])
    out["pool"] = pool
    _, logits = jax_runner.decode_step(params, st, tokens, active, CFG)
    out["decode_step"] = np.asarray(logits)
    _, logits = jax_paged.decode_step_paged(
        params, jax_paged.PagedState(*(jnp.asarray(pool[n]) for n in
                                       ("k", "v", "block_tables", "lengths"))),
        tokens, active, CFG)
    out["decode_step_paged"] = np.asarray(logits)
    greedy = []
    st = jax_runner.init_state(CFG, SLOTS, MAX_LEN, mesh)
    for prompt in ENGINE_PROMPTS:
        st, last = jax_runner.prefill(params, st, jnp.asarray(_padded(prompt)),
                                      jnp.int32(len(prompt)), jnp.int32(0), CFG)
        ids = [int(jnp.argmax(last))]
        while len(ids) < GREEDY_TOKENS:
            st, logits = jax_runner.decode_step(
                params, st, jnp.asarray([ids[-1], 0], jnp.int32), jnp.asarray([True, False]),
                CFG)
            ids.append(int(jnp.argmax(logits[0])))
        greedy.append(ids)
    out["greedy"] = greedy
    return out


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_prefill_and_decode_match_jax(jax_out, pt_qparams, layout):
    """Prefill into two slots and one decode step on the JAX-quantized
    weights: logits within 1e-5 of JAX's, in the slot layout and on the same
    KV laid out in blocks."""
    st = pt_runner.init_state(PT_CFG, SLOTS, MAX_LEN, "cpu")
    lasts = []
    for slot, prompt in PROMPTS.items():
        st, last = pt_runner.prefill(pt_qparams, st, torch.from_numpy(_padded(prompt)).long(),
                                     len(prompt), slot, PT_CFG)
        lasts.append(last)
    np.testing.assert_allclose(torch.stack(lasts).numpy(), jax_out["prefill"], rtol=TOL,
                               atol=TOL)
    tokens, active = torch.tensor([17, 250]), torch.tensor([True, True])
    if layout == "slot":
        _, logits = pt_runner.decode_step(pt_qparams, st, tokens, active, PT_CFG)
    else:
        pool = _paged_from_slots(st.k.numpy(), st.v.numpy(), st.lengths.numpy())
        pst = pt_paged.PagedState(*(torch.from_numpy(pool[n]) for n in ("k", "v")),
                                  torch.from_numpy(pool["block_tables"]).long(),
                                  torch.from_numpy(pool["lengths"]).long())
        _, logits = pt_paged.decode_step_paged(pt_qparams, pst, tokens, active, PT_CFG)
    want = jax_out["decode_step" if layout == "slot" else "decode_step_paged"]
    np.testing.assert_allclose(logits.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_engine_greedy_matches_jax(jax_out, jax_params, layout):
    """The slice as a whole: an engine given the f32 weights and
    quantization="int8" quantizes them itself and serves two concurrent
    greedy requests with the token ids of a greedy loop over the JAX
    functions on JAX-quantized weights."""
    kw = dict(kv_layout="paged", kv_block_size=BS) if layout == "paged" else {}
    eng = TorchLLMEngine(LLMConfig(model_source="byte-tiny", max_num_seqs=SLOTS,
                                   max_model_len=MAX_LEN, dtype="float32",
                                   quantization="int8", num_decode_steps=4, **kw),
                         params=bridge.params_from_jax(jax_params, PT_CFG, device="cpu"),
                         device="cpu")
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
    assert isinstance(eng.params["layers"]["wq"], pt_quant.QTensor)
    assert got == jax_out["greedy"]


def test_unknown_quantization_raises_the_jax_engines_error():
    """Before any weight is built (ray_tpu/llm/engine.py:302-307)."""
    with pytest.raises(ValueError, match=r"unknown quantization 'fp8' \(supported: int8\)"):
        LLMConfig(quantization="fp8")
