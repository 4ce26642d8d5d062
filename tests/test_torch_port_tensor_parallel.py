"""Port parity: a device mesh and tensor-parallel serving (ray_tpu_torch/
parallel/, the mesh paths of models/llama.py, llm/model_runner.py,
llm/paged.py and models/checkpoint.py, and the engine's followers in
llm/tp_worker.py) against the JAX package at tp = 2, in f32 on byte-tiny.

The JAX side runs on 2 of the 8 host CPU devices that tests/conftest.py
forces: its shard_params and its jitted prefill / decode_step and paged
functions on a ("dp", "ep", "tp") = (1, 1, 2) mesh, as JaxLLMEngine.start
builds one; no JAX engine is started. The port side runs on gloo CPU ranks:
two spawned processes for the function-level checks (tests/_torch_tp_ranks.py,
once for the module), and each tensor-parallel engine's own follower. Every
wait is bounded: the groups time out after 60 s, and every join and queue
read has a timeout.
"""
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_tp_ranks as tp_ranks
from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import paged as jax_paged
from ray_tpu.models import config as jax_config
from ray_tpu.models import llama as jax_llama
from ray_tpu.ops.quant import quantize_llama_params as jax_quantize
from ray_tpu.parallel import mesh as jax_mesh_mod
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu_torch import parallel
from ray_tpu_torch.llm import LLMConfig, LLMServer, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import config as pt_llm_config
from ray_tpu_torch.models import bridge, checkpoint
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.models import llama as pt_llama

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # logits, relative to max|ref|: f32 on both sides, the sums in other orders
CFG = jax_config.get_config("byte-tiny")
PT_CFG = pt_config.get_config("byte-tiny")
TP = 2
PROMPTS = [[1, 7, 42, 99, 5, 6, 200, 3, 11], [1, 3, 3, 300, 9]]
BUCKET, MAX_LEN, NUM_BLOCKS, BS = 16, 64, 8, 16
INSTALL_AT = [5, 2]
N_FED = 3  # decode steps teacher-forced with JAX's greedy tokens
GREEDY = 16
P = [1, 10, 20, 30, 40, 50, 60, 70]
ENGINE = dict(model_source="byte-tiny", dtype="float32", max_num_seqs=2, max_model_len=MAX_LEN)
# the paged engines: a prefix hit of one block (PREFIX_MIN_HIT_TOKENS 1), a
# chunk of 16, and a pool of 8 blocks
PAGED = dict(kv_layout="paged", kv_block_size=BS, num_kv_blocks=NUM_BLOCKS, prefill_chunk=16)
SHARED = [1] + list(range(100, 115))  # one full block, shared by two prompts


def _greedy_params(max_tokens=GREEDY):
    return SamplingParams(max_tokens=max_tokens, temperature=0.0, stop_token_ids=[-1])


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(np_params):
    return bridge.params_from_jax(np_params, PT_CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:TP]).reshape(1, 1, TP), ("dp", "ep", "tp"))


@pytest.fixture(scope="module")
def jax_sharded(np_params, jax_mesh):
    """JAX's tp 2 weights: shard_params, then (int8) the jitted
    quantize_llama_params on the sharded tree, as JaxLLMEngine.start does."""
    f32 = jax_runner.shard_params(np_params, CFG, jax_mesh)
    return {"f32": f32, "int8": jax.jit(jax_quantize)(f32)}


@pytest.fixture(scope="module")
def ranks():
    r = tp_ranks.Ranks(TP)
    yield r
    r.close()


def _jax_greedy(params, mesh, prompt, n=GREEDY):
    """JAX's tp 2 prefill, then decode_step n - 1 times, greedy: (ids,
    logits of each step)."""
    state = jax_runner.init_state(CFG, 2, MAX_LEN, mesh)
    bucket = max(BUCKET, 1 << (len(prompt) - 1).bit_length())
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :len(prompt)] = prompt
    state, last = jax_runner.prefill(params, state, jnp.asarray(tokens),
                                     jnp.int32(len(prompt)), jnp.int32(0), CFG)
    logits = [np.asarray(last)]
    ids = [int(np.argmax(logits[-1]))]
    for _ in range(n - 1):
        state, lg = jax_runner.decode_step(params, state, jnp.asarray([ids[-1], 0], jnp.int32),
                                           jnp.asarray([True, False]), CFG)
        logits.append(np.asarray(lg[0]))
        ids.append(int(np.argmax(logits[-1])))
    return ids, logits


@pytest.fixture(scope="module")
def jax_ids(jax_sharded, jax_mesh):
    """JAX's greedy ids: the id prompts in f32 and int8, P's continuation C,
    and P + C + P (the speculative engine's prompt: its trailing n-gram
    occurred before, so it drafts)."""
    f32, int8 = jax_sharded["f32"], jax_sharded["int8"]
    out = {("f32", i): _jax_greedy(f32, jax_mesh, p)[0] for i, p in enumerate(PROMPTS)}
    cont = _jax_greedy(f32, jax_mesh, P, 8)[0]
    out["spec_prompt"] = P + cont + P
    out["spec"] = _jax_greedy(f32, jax_mesh, out["spec_prompt"])[0]
    for name, prompt in (("a", SHARED + [7, 8, 9, 10]), ("b", SHARED + [40, 41, 42])):
        out[("int8", name)] = _jax_greedy(int8, jax_mesh, prompt)[0]
        out[("prompt", name)] = prompt
    return out


@pytest.fixture(scope="module")
def jax_logits(jax_sharded, jax_mesh):
    """JAX's tp 2 logits over PROMPTS: prefill (slot, and detached +
    installed for paged), then N_FED decode steps teacher-forced with the
    slot run's greedy tokens."""
    params = jax_sharded["f32"]
    state = jax_runner.init_state(CFG, len(PROMPTS), MAX_LEN, jax_mesh)
    pool = jax_paged.init_paged_state(CFG, len(PROMPTS), MAX_LEN, NUM_BLOCKS, BS, jax_mesh)
    first, first_paged = [], []
    for slot, prompt in enumerate(PROMPTS):
        tokens = np.zeros((1, BUCKET), np.int32)
        tokens[0, :len(prompt)] = prompt
        state, last = jax_runner.prefill(params, state, jnp.asarray(tokens),
                                         jnp.int32(len(prompt)), jnp.int32(slot), CFG)
        first.append(np.asarray(last))
        k, v, last = jax_runner.prefill_detached(params, jnp.asarray(tokens),
                                                 jnp.int32(len(prompt)), CFG)
        pool = jax_paged.install_prefill(pool, k, v, jnp.asarray([INSTALL_AT[slot]], jnp.int32),
                                         jnp.int32(len(prompt)), jnp.int32(slot), n_blocks=1)
        first_paged.append(np.asarray(last))
    active = jnp.asarray([True] * len(PROMPTS))
    feed, steps, steps_paged = [], [], []
    row = [int(np.argmax(lg)) for lg in first]
    for _ in range(N_FED):
        feed.append(row)
        state, lg = jax_runner.decode_step(params, state, jnp.asarray(row, jnp.int32), active,
                                           CFG)
        pool, lg_paged = jax_paged.decode_step_paged(params, pool, jnp.asarray(row, jnp.int32),
                                                     active, CFG)
        steps.append(np.asarray(lg))
        steps_paged.append(np.asarray(lg_paged))
        row = [int(t) for t in np.argmax(np.asarray(lg), axis=-1)]
    return {"feed": feed, "slot": (np.stack(first), np.stack(steps)),
            "paged": (np.stack(first_paged), np.stack(steps_paged))}


def _assert_close(got, ref, what):
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, f"{what}: max|d| / max|ref| = {err}"


# -- the mesh and the rules ----------------------------------------------------------------

def test_axis_rules_and_order_are_jax_s():
    assert parallel.AXIS_ORDER == jax_mesh_mod.AXIS_ORDER
    for ours, theirs in ((parallel.TRAIN_RULES, jax_sharding.TRAIN_RULES),
                         (parallel.INFER_RULES, jax_sharding.INFER_RULES)):
        assert ours.rules == theirs.rules
        for axes in (("batch", "seq", "act_embed"), ("layer", "embed", "heads", "head_dim"),
                     ("vocab", "embed"), (None, "mlp")):
            assert parallel.logical_to_mesh_axes(axes, ours) == tuple(
                jax_sharding.logical_to_mesh_axes(axes, theirs))


@pytest.mark.parametrize("name", ["byte-tiny", "moe-tiny"])
def test_param_axes_are_jax_s_scanned_tree(name):
    cfg = jax_config.get_config(name)
    assert cfg.scan_layers
    assert pt_llama.param_axes(pt_config.get_config(name)) == jax_llama.param_axes(cfg)


@pytest.mark.parametrize("spec,n", [(dict(tp=2), 2), (dict(dp=-1, tp=2), 8),
                                    (dict(pp=2, dp=-1), 4), (dict(dp=2, sp=2, tp=2), 8)])
def test_mesh_spec_resolves_as_jax_s(spec, n):
    ours = parallel.MeshSpec(**spec).resolve(n)
    theirs = jax_mesh_mod.MeshSpec(**spec).resolve(n)
    assert ours.sizes() == theirs.sizes() and ours.n_devices == theirs.n_devices == n


@pytest.mark.parametrize("spec,n", [(dict(dp=-1, tp=-1), 4), (dict(tp=3), 4),
                                    (dict(dp=-1, tp=3), 4)])
def test_mesh_spec_refuses_what_jax_refuses(spec, n):
    with pytest.raises(ValueError):
        jax_mesh_mod.MeshSpec(**spec).resolve(n)
    with pytest.raises(ValueError):
        parallel.MeshSpec(**spec).resolve(n)


class _FakeMesh:
    """A DeviceMesh's size / coordinate queries at one rank's coordinate."""

    mesh_dim_names = parallel.AXIS_ORDER

    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def size(self, i):
        return self.sizes[i]

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


def test_shards_are_the_slices_of_jax_s_named_sharding():
    """A [8, 6, 4] array with axes (batch, None, heads) under TRAIN_RULES on a
    (pp, dp, fsdp, ep, sp, tp) = (1, 2, 2, 1, 1, 2) mesh: batch splits over
    (dp, fsdp), major first, heads over tp; each rank's shard is the slice
    JAX gives the device at its coordinate."""
    sizes = (1, 2, 2, 1, 1, 2)
    devices = np.asarray(jax.devices()[:8]).reshape(sizes)
    mesh = Mesh(devices, jax_mesh_mod.AXIS_ORDER)
    x = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
    axes = ("batch", None, "heads")
    arr = jax.device_put(x, jax_sharding.named_sharding(mesh, *axes,
                                                        rules=jax_sharding.TRAIN_RULES))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for coord in np.ndindex(*sizes):
        fake = _FakeMesh(sizes, coord)
        got = parallel.shard_leaf(torch.from_numpy(x), axes, fake, parallel.TRAIN_RULES)
        np.testing.assert_array_equal(got.numpy(), by_device[devices[coord]])
        assert parallel.local_shape(x.shape, axes, fake, parallel.TRAIN_RULES) == (2, 6, 2)


def test_backend_follows_the_devices():
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert parallel.mesh_backend([cpu, cpu]) == "gloo"
    assert parallel.mesh_backend([c0, c1]) == "nccl"
    assert parallel.mesh_backend([c0, c0]) == "gloo"  # two ranks sharing one card
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        parallel.mesh_backend([cpu, c0])


def test_build_mesh_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices"):
        parallel.build_mesh(parallel.MeshSpec(tp=2))


def test_build_mesh_needs_a_rank_to_start_a_group():
    with pytest.raises(ValueError, match="rank= and init_method="):
        parallel.build_mesh(parallel.MeshSpec(tp=2), ["cpu", "cpu"])


def test_the_ranks_form_one_gloo_mesh(ranks):
    assert ranks.run(tp_ranks.world) == [(0, TP, "gloo"), (1, TP, "gloo")]


# -- shards --------------------------------------------------------------------------------

def _jax_shard(leaf, mesh, r):
    """The shard of a JAX leaf on the device at tp index r."""
    device = mesh.devices.reshape(-1)[r]
    return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == device)


@pytest.mark.parametrize("int8", [False, True])
def test_shards_are_bit_equal_to_jax_s(ranks, np_params, jax_sharded, jax_mesh, int8):
    """Every leaf's shard on port rank r, float and int8 (q and its scales),
    equals the JAX leaf's addressable shard at tp index r, bit for bit: the
    port's shard_params (int8: its own quantization of the whole tree,
    then cut) and the bridge's shard of JAX's whole tree (int8: JAX's
    jitted quantize_llama_params of the unsharded tree)."""
    theirs = jax_sharded["int8" if int8 else "f32"]
    jax_int8 = None
    if int8:
        jax_int8 = jax.tree_util.tree_map(np.asarray, jax.jit(jax_quantize)(np_params))
    got = ranks.run(tp_ranks.shards, np_params, "byte-tiny", jax_int8)
    for r in range(TP):
        for mine in got[r]:
            leaves = [(name, mine[name], theirs[name]) for name in mine if name != "layers"]
            leaves += [(f"layers/{k}", v, theirs["layers"][k])
                       for k, v in mine["layers"].items()]
            for name, ours, ref in leaves:
                parts = zip(ours, ref) if isinstance(ours, tuple) else [(ours, ref)]
                for o, t in parts:
                    np.testing.assert_array_equal(o, _jax_shard(t, jax_mesh, r), err_msg=name)
    mine = got[0][0]
    assert mine["layers"]["wq"].shape[2] == CFG.n_heads // TP
    if int8:  # wo's scales are whole on each rank, wq's cut with its heads
        assert mine["layers"]["wo"].s.shape == np_params["layers"]["wo"][:, :1].shape
        assert mine["layers"]["wq"].s.shape[2] == CFG.n_heads // TP


@pytest.mark.parametrize("int8", [False, True])
def test_seeded_init_on_the_mesh_is_the_shard_of_the_whole(ranks, int8):
    for sharded, whole in ranks.run(tp_ranks.seeded_shards, "byte-tiny", int8):
        for a, b in zip(pt_llama.tree_leaves(sharded), pt_llama.tree_leaves(whole)):
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("int8", [False, True])
def test_checkpoint_load_on_the_mesh_is_the_shard_of_the_whole(ranks, pt_params, tmp_path,
                                                               int8):
    src = checkpoint.save_llama_params(pt_params, PT_CFG, str(tmp_path / "ckpt"))
    for sharded, whole in ranks.run(tp_ranks.loaded_shards, src, int8):
        for a, b in zip(pt_llama.tree_leaves(sharded), pt_llama.tree_leaves(whole)):
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                np.testing.assert_array_equal(x, y)


def test_vocab_parallel_lookup_keeps_the_gather_s_clamp(ranks):
    """C1 on the mesh: ids are wrapped once and clamped against the GLOBAL
    vocabulary before each rank takes its rows, so out-of-range ids read
    the rows the tp 1 gather reads (JAX's gather semantics), on both ranks."""
    v, d = 16, 4
    table = np.random.default_rng(5).standard_normal((v, d)).astype(np.float32)
    ids = np.array([[0, 7, 8, 15, -1, -16, -17, 16, 99, -99]], np.int64)
    want = pt_llama._embed_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                                  torch.float32).numpy()
    for got in ranks.run(tp_ranks.embed_rows, table, ids):
        np.testing.assert_array_equal(got, want)


# -- logits --------------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_tp2_logits_match_jax_tp2_functions(ranks, np_params, jax_logits, layout):
    """Prefill, then decode steps fed JAX's greedy tokens, in each layout:
    within 1e-5 of max|ref| of JAX's tp 2 functions, and the same bits on
    both ranks (what keeps sampling in step)."""
    if layout == "slot":
        got = ranks.run(tp_ranks.slot_logits, np_params, "byte-tiny", PROMPTS, BUCKET, MAX_LEN,
                        jax_logits["feed"])
    else:
        got = ranks.run(tp_ranks.paged_logits, np_params, "byte-tiny", PROMPTS, BUCKET,
                        MAX_LEN, NUM_BLOCKS, BS, INSTALL_AT, jax_logits["feed"])
    (first, steps), other = got[0], got[1]
    ref_first, ref_steps = jax_logits[layout]
    _assert_close(first, ref_first, f"{layout} prefill")
    _assert_close(steps, ref_steps, f"{layout} decode")
    np.testing.assert_array_equal(first, other[0])
    np.testing.assert_array_equal(steps, other[1])


# -- the engine on a mesh ----------------------------------------------------------------------

def _engine(params, **kw):
    return TorchLLMEngine(LLMConfig(**{**ENGINE, **kw}), params=params, device="cpu")


def _no_children_left(followers):
    deadline = time.monotonic() + 10
    while any(p.is_alive() for p in followers) and time.monotonic() < deadline:
        time.sleep(0.05)
    return not any(p.is_alive() for p in followers)


def test_server_at_tp2_serves_jax_s_greedy_ids(pt_params, jax_ids):
    """LLMServer over a tp 2 slot engine (fused bursts of 4): the greedy ids
    of JAX and of the port at tp 1; chat and completions answered with the
    tp 1 server's texts; a sampled request takes the tp 1 engine's tokens
    (the same all-gathered logits and generators on both ranks)."""
    one = _engine(pt_params, num_decode_steps=4)
    two = _engine(pt_params, num_decode_steps=4, tensor_parallel_size=TP)
    servers = [LLMServer(e.config, engine=e) for e in (one, two)]
    try:
        followers = list(two._followers.procs)
        assert [str(d) for d in two.devices] == ["cpu", "cpu"]
        for i, prompt in enumerate(PROMPTS):
            ids = [e.generate_sync(prompt, _greedy_params()).token_ids for e in (one, two)]
            assert ids[0] == ids[1] == jax_ids[("f32", i)]
        sampled = SamplingParams(max_tokens=12, temperature=0.8, top_k=20, stop_token_ids=[-1])
        got = [e.generate_sync(PROMPTS[0], sampled) for e in (one, two)]
        assert got[1].finish_reason == "length" and got[0].token_ids == got[1].token_ids
        body = {"max_tokens": 8, "temperature": 0.0}
        chats = [s.chat({**body, "messages": [{"role": "user", "content": "hi tp"}]})
                 for s in servers]
        texts = [s.completions({**body, "prompt": "tensor parallel"}) for s in servers]
        assert chats[0]["choices"] == chats[1]["choices"]
        assert texts[0]["choices"] == texts[1]["choices"]
        servers[1].check_health()
        assert set(two.metrics()) == set(one.metrics())
    finally:
        for s in servers:
            s.shutdown()
    assert _no_children_left(followers)


def test_paged_speculative_engine_at_tp2(pt_params, jax_ids):
    """Paged, n-gram speculation (k 2, fused windows of 4 and single
    windows): JAX's greedy ids on P + C + P, with drafts."""
    eng = _engine(pt_params, tensor_parallel_size=TP, num_speculative_tokens=2,
                  num_decode_steps=4, **PAGED)
    try:
        out = eng.generate_sync(jax_ids["spec_prompt"], _greedy_params())
        assert out.token_ids == jax_ids["spec"]
        assert eng.metrics()["num_spec_drafted"] > 0
    finally:
        eng.shutdown()


def test_paged_int8_engine_at_tp2_with_a_prefix_hit(pt_params, jax_ids, monkeypatch):
    """Paged int8 (quantized whole, then sharded): JAX's int8 greedy ids for
    two prompts that share a full block, the second served over the first's
    cached block, its decode growing into new blocks."""
    monkeypatch.setattr(pt_llm_config, "PREFIX_MIN_HIT_TOKENS", 1)
    one = _engine(pt_params, quantization="int8", **PAGED)
    two = _engine(pt_params, tensor_parallel_size=TP, quantization="int8", **PAGED)
    try:
        for name in ("a", "b"):
            ids = [e.generate_sync(jax_ids[("prompt", name)], _greedy_params()).token_ids
                   for e in (one, two)]
            assert ids[0] == ids[1] == jax_ids[("int8", name)]
        assert two.metrics()["prefix_cache_hit_tokens"] == BS
    finally:
        one.shutdown()
        two.shutdown()


def test_checkpoint_on_the_mesh_serves_the_fed_params_ids(pt_params, jax_ids, tmp_path):
    """tests/test_checkpoint_io.py:97-124 on the port: a checkpoint loaded
    with the mesh gives the ids of the engine fed the params (here JAX's)."""
    src = checkpoint.save_llama_params(pt_params, PT_CFG, str(tmp_path / "ckpt"))
    eng = TorchLLMEngine(LLMConfig(**{**ENGINE, "model_source": src,
                                      "engine_kwargs": {"dtype": "float32"}},
                                   tensor_parallel_size=TP), device="cpu")
    try:
        for i, prompt in enumerate(PROMPTS):
            assert eng.generate_sync(prompt, _greedy_params()).token_ids == jax_ids[("f32", i)]
    finally:
        eng.shutdown()


def test_a_killed_follower_fails_requests_without_a_hang(pt_params):
    """A follower killed in the middle of a request: the request finishes
    with "error", the server reports unhealthy, a later request fails at
    once, and shutdown leaves no child alive."""
    eng = _engine(pt_params, tensor_parallel_size=TP, num_decode_steps=1)
    server = LLMServer(eng.config, engine=eng)
    followers = list(eng._followers.procs)
    try:
        stream = eng.generate(PROMPTS[0], _greedy_params(40))
        first = next(stream)
        assert first.token_ids and not first.finished
        followers[0].kill()
        t0 = time.monotonic()
        outs = list(stream)
        assert outs[-1].finish_reason == "error"
        assert time.monotonic() - t0 < 30
        with pytest.raises(RuntimeError, match="tensor-parallel"):
            server.check_health()
        assert eng.generate_sync(PROMPTS[1], _greedy_params()).finish_reason == "error"
    finally:
        server.shutdown()
    assert _no_children_left(followers)
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("tp-")]


# -- what tp does not serve ------------------------------------------------------------------

@pytest.mark.parametrize("kw,field", [
    (dict(tensor_parallel_size=3), "n_heads"),
    (dict(tensor_parallel_size=2, engine_kwargs={"n_kv_heads": 1}), "n_kv_heads"),
    (dict(tensor_parallel_size=2, engine_kwargs={"d_ff": 129}), "d_ff"),
    (dict(tensor_parallel_size=2, engine_kwargs={"vocab_size": 513}), "vocab_size")])
def test_sizes_that_do_not_divide_raise(kw, field):
    with pytest.raises(ValueError, match=f"{field} .* not divisible by tensor_parallel_size"):
        LLMConfig(model_source="byte-tiny", **kw)


def test_moe_under_tp_raises_naming_a6():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        LLMConfig(model_source="moe-tiny", tensor_parallel_size=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        pt_llama.check_tensor_parallel(pt_config.get_config("moe-tiny"),
                                       _FakeMesh((1, 1, 1, 1, 1, 2), (0,) * 6))


def test_pd_under_tp_raises_naming_a6():
    """Before any follower starts."""
    eng = TorchLLMEngine(LLMConfig(**ENGINE, tensor_parallel_size=TP), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        eng.prefill_only([1, 2, 3], _greedy_params())
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        eng.generate_from_prefill({"prompt_ids": [1], "k": None, "v": None,
                                   "first_token": 1}, _greedy_params())
    assert eng._followers is None and not eng._started


def test_other_parallel_sizes_still_raise():
    for kw, item in ((dict(model_source="moe-tiny", data_parallel_size=2,
                           tensor_parallel_size=2), "A6"),
                     (dict(expert_parallel_size=2), "A6"),
                     (dict(pipeline_parallel_size=2, tensor_parallel_size=2,
                           expert_parallel_size=2), "A6")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP .*{item}"):
            LLMConfig(**kw)


def test_tp_devices_must_match_the_ranks():
    with pytest.raises(ValueError, match="1 devices for tensor_parallel_size 2"):
        TorchLLMEngine(LLMConfig(**ENGINE, tensor_parallel_size=TP), devices=["cpu"])
