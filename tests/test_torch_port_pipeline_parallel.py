"""Port parity: pipelined serving (``LLMConfig(pipeline_parallel_size=2)``:
parallel/pipeline.py's hop between stages, model_runner's and paged's _pp
functions through the microbatch schedule, a stage's layers and KV, the
stages of llm/tp_worker.py and the engine's per-step decode) against the
JAX package at pp 2, pp 2 x dp 2 and pp 2 x tp 2, in f32 on test-tiny.

The JAX side runs on the host CPU devices that tests/conftest.py forces: its
jitted decode_step_pp / spec_verify_step_pp and decode_step_paged_pp /
spec_verify_step_paged_pp on ("pp", "dp", "ep", "tp") meshes of (2, 1, 1, 1),
(2, 2, 1, 1) and (2, 1, 1, 2), computed once per module in a thread of
their own while the engine tests run; their states are built from its
one-device prefill (the KV of a prompt does not depend on the mesh). The
engines' reference ids are its one-device greedy ids: JAX's own tests hold
its pp engines to the one-device engine token for token
(tests/test_paged_kv.py:139-173, 392-523; tests/test_llm.py:511-551). No
JAX engine is started. The port side runs on one pool of 4 spawned gloo
CPU ranks (tests/_torch_tp_ranks.py): pp 2 x dp 2 as MeshSpec(pp=2, dp=2),
pp 2 x tp 2 as MeshSpec(pp=2, tp=2), and pp 2 alone as MeshSpec(pp=2,
fsdp=2), whose fsdp pairs are two copies of one pp 2 run (INFER_RULES cut
no serving weight over fsdp). Each engine spawns its own followers. Every
wait is bounded: the groups time out after 60 s, and every join and queue
read has a timeout (TIMEOUT_S).
"""
import dataclasses
import functools
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_tp_ranks as tp_ranks
from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import paged as jax_paged
from ray_tpu.models import config as jax_config
from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import engine as pt_engine
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models import bridge, checkpoint
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.parallel import MeshSpec

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # relative to max|ref|: f32 on both sides, the sums in other orders
TIMEOUT_S = tp_ranks.TIMEOUT_S
CFG = jax_config.get_config("test-tiny")
PT_CFG = pt_config.get_config("test-tiny")
SPECS = {"pp2": MeshSpec(pp=2, fsdp=2), "pp2dp2": MeshSpec(pp=2, dp=2),
         "pp2tp2": MeshSpec(pp=2, tp=2)}
JAX_SHAPES = {"pp2": (2, 1, 1, 1), "pp2dp2": (2, 2, 1, 1), "pp2tp2": (2, 1, 1, 2)}
ENGINE_KW = {"pp2": dict(pipeline_parallel_size=2),
             "pp2dp2": dict(pipeline_parallel_size=2, data_parallel_size=2),
             "pp2tp2": dict(pipeline_parallel_size=2, tensor_parallel_size=2)}
# the function checks: 4 slots (2 a replica at dp 2, microbatches of 1 or 2
# slots), 32-token buckets installed into two 16-token blocks, a third block
# appended; the 30-token prompt's fed steps cross into it. Slot 3 is
# inactive in the fed steps and the verify window: its paged writes go to
# the scratch block, its slot-layout ones to lengths[3].
S, MAX_LEN, BS, NUM_BLOCKS, BUCKET = 4, 64, 16, 16, 32
PROMPTS = [[1, 7, 42, 99, 5, 6, 200, 3, 11, 9, 8, 77, 12, 13, 14],
           [1, 3, 3, 100, 9, 4, 4, 4, 2],
           [1] + list(range(100, 129)),
           [1, 50, 51, 52, 50, 51, 52, 50, 51, 52, 50, 60, 61, 62, 63, 64, 65]]
ACTIVE = [True, True, True, False]
N_FED = 3
# the engines: JAX's test_paged_kv.py prompts (byte tokenizer) and lengths
COMMON = dict(model_source="test-tiny", dtype="float32", max_num_seqs=4, max_model_len=128)
TEXTS = ("pipeline me", "another prompt")
LONG_TEXT = "long decode across block boundaries " * 2
TOGETHER = ("a b c", "d e f", "g h i", "j k l")
SPEC_PROMPT = [1, 10, 11, 12, 13]


def _greedy(max_tokens=8):
    return SamplingParams(max_tokens=max_tokens, temperature=0.0, stop_token_ids=[-1])


def _ids(text):
    return get_tokenizer("byte").encode(text)


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(np_params):
    return bridge.params_from_jax(np_params, PT_CFG, device="cpu")


@pytest.fixture(scope="module")
def ranks():
    r = tp_ranks.Ranks(4, SPECS["pp2dp2"])
    yield r
    r.close()


# -- JAX's references ------------------------------------------------------------------------

def _jax_mesh(kind):
    shape = JAX_SHAPES[kind]
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("pp", "dp", "ep", "tp"))


def _tokens(prompt, bucket):
    t = np.zeros((1, bucket), np.int32)
    t[0, :len(prompt)] = prompt
    return jnp.asarray(t)


def _jax_greedy_ids(params, prompt, n):
    """JAX's one-device prefill into slot 0, then decode_step n - 1 times, greedy."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "ep", "tp"))
    state = jax_runner.init_state(CFG, 1, COMMON["max_model_len"], mesh)
    bucket = max(16, 1 << (len(prompt) - 1).bit_length())
    state, last = jax_runner.prefill(params, state, _tokens(prompt, bucket),
                                     jnp.int32(len(prompt)), jnp.int32(0), CFG)
    ids = [int(np.argmax(np.asarray(last)))]
    for _ in range(n - 1):
        state, lg = jax_runner.decode_step(params, state, jnp.asarray([ids[-1]], jnp.int32),
                                           jnp.asarray([True]), CFG)
        ids.append(int(np.argmax(np.asarray(lg[0]))))
    return ids


@pytest.fixture(scope="module")
def jax_ids(np_params):
    """JAX's greedy ids for every prompt the engines serve."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = {t: _jax_greedy_ids(params, _ids(t), 8) for t in TEXTS + TOGETHER}
    out[LONG_TEXT] = _jax_greedy_ids(params, _ids(LONG_TEXT), 24)
    out["spec"] = _jax_greedy_ids(params, SPEC_PROMPT, 12)
    return out


def _prefills(params):
    """JAX's one-device prefill_detached of every prompt -> (k, v [L, 1,
    BUCKET, KV, HD] each, the last-token logits [S, V])."""
    ks, vs, first = [], [], []
    for prompt in PROMPTS:
        k, v, last = jax_runner.prefill_detached(params, _tokens(prompt, BUCKET),
                                                 jnp.int32(len(prompt)), CFG)
        ks.append(np.asarray(k))
        vs.append(np.asarray(v))
        first.append(np.asarray(last))
    return ks, vs, np.stack(first)


def _slot_state(ks, vs):
    """The slot cache [L, S, MAX_LEN, KV, HD] with each prompt in its slot."""
    k = np.zeros((CFG.n_layers, S, MAX_LEN, CFG.n_kv_heads, CFG.head_dim), np.float32)
    v = np.zeros_like(k)
    for slot, (pk, pv) in enumerate(zip(ks, vs)):
        k[:, slot, :BUCKET], v[:, slot, :BUCKET] = pk[:, 0], pv[:, 0]
    return dict(k=k, v=v, lengths=np.asarray([len(p) for p in PROMPTS], np.int32))


def _paged_plan(dp):
    """Block ids of each slot's two prompt blocks and its appended third
    (replica-local under dp), in the order the pool hands them out."""
    per = S // dp
    local = [slot % per for slot in range(S)]
    ids = [[2 * n + 1, 2 * n] for n in local]
    appends = [(2, 2 * per + n) for n in local]
    return ids, appends


def _paged_state(ks, vs, dp):
    """JAX's pool [L, NB + dp, BS, KV, HD] (replica r's partition at r *
    (NB / dp + 1), its last block the scratch), tables and lengths."""
    ids, appends = _paged_plan(dp)
    per_blocks, per = NUM_BLOCKS // dp, S // dp
    shape = (CFG.n_layers, NUM_BLOCKS + dp, BS, CFG.n_kv_heads, CFG.head_dim)
    k, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    tables = np.zeros((S, MAX_LEN // BS), np.int32)
    for slot, (pk, pv) in enumerate(zip(ks, vs)):
        base = slot // per * (per_blocks + 1)
        for j, bid in enumerate(ids[slot]):
            k[:, base + bid] = pk[:, 0, j * BS:(j + 1) * BS]
            v[:, base + bid] = pv[:, 0, j * BS:(j + 1) * BS]
        tables[slot, :2] = ids[slot]
        index, bid = appends[slot]
        tables[slot, index] = bid
    return dict(k=k, v=v, block_tables=tables,
                lengths=np.asarray([len(p) for p in PROMPTS], np.int32))


@pytest.fixture(scope="module")
def plan(np_params):
    """The fed tokens, and a verify window after them: the greedy token t0
    of the last fed step, then drafts from the one-device greedy
    continuation (slot 0 all right, slot 1 one right, slot 2 wrong, slot 3
    inactive), from JAX's one-device decode_step."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    ks, vs, _ = _prefills(params)
    st = _slot_state(ks, vs)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "ep", "tp"))
    sh = NamedSharding(mesh, P())
    state = jax_runner.DecodeState(*(jax.device_put(jnp.asarray(st[n]), sh)
                                     for n in ("k", "v", "lengths")))
    feed = np.random.RandomState(1).randint(1, CFG.vocab_size, (N_FED, S)).tolist()
    active = jnp.asarray(ACTIVE)
    for row in feed:
        state, lg = jax_runner.decode_step(params, state, jnp.asarray(row, jnp.int32), active,
                                           CFG)
    cont = [np.asarray(lg).argmax(-1)]
    for _ in range(2):
        state, lg = jax_runner.decode_step(params, state, jnp.asarray(cont[-1], jnp.int32),
                                           active, CFG)
        cont.append(np.asarray(lg).argmax(-1))
    t0, d1, d2 = (c.tolist() for c in cont)
    window = [[t0[0], d1[0], d2[0]], [t0[1], d1[1], 7], [t0[2], 7, 7], [t0[3], d1[3], d2[3]]]
    return dict(prompts=PROMPTS, feed=feed, active=ACTIVE, window=window,
                draft_len=[2, 2, 2, 1], max_len=MAX_LEN, bs=BS, num_blocks=NUM_BLOCKS,
                bucket=BUCKET)


def _put(mesh, arrays, specs):
    return [jax.device_put(jnp.asarray(a), NamedSharding(mesh, sp))
            for a, sp in zip(arrays, specs)]


def _copy(state):
    return {name: np.array(getattr(state, name)) for name in state._fields}


def _jax_functions(np_params, plan, kind, layout):
    """JAX's pp functions on `kind`'s mesh in pp_functions' order."""
    mesh = _jax_mesh(kind)
    params = jax_runner.shard_params(np_params, CFG, mesh)
    ks, vs, first = _prefills(jax.tree_util.tree_map(jnp.asarray, np_params))
    dp = JAX_SHAPES[kind][1]
    if layout == "paged":
        st = _paged_state(ks, vs, dp)
        pool = jax_paged.POOL_SPEC_PP_DP if dp > 1 else jax_paged.POOL_SPEC_PP
        rows = P("dp") if dp > 1 else P()
        state = jax_paged.PagedState(*_put(mesh, [st[n] for n in jax_paged.PagedState._fields],
                                           [pool, pool, rows, rows]))
        step = jax_paged.decode_step_paged_pp
        verify = jax_paged.spec_verify_step_paged_pp
    else:
        st = _slot_state(ks, vs)
        state = jax_runner.DecodeState(*_put(mesh, [st["k"], st["v"], st["lengths"]],
                                             [jax_runner.CACHE_SPEC_PP] * 2 + [P("dp")]))
        step, verify = jax_runner.decode_step_pp, jax_runner.spec_verify_step_pp
    step = jax.jit(functools.partial(step, cfg=CFG, mesh=mesh))
    verify = jax.jit(functools.partial(verify, cfg=CFG, mesh=mesh))
    out = {"first": first, "installed": _copy(state)}
    active = jnp.asarray(plan["active"])
    steps = []
    for row in plan["feed"]:
        state, lg = step(params, state, jnp.asarray(row, jnp.int32), active)
        steps.append(np.asarray(lg))
    out["steps"], out["decoded"] = np.stack(steps), _copy(state)
    greedy = (jnp.zeros((S,)), jnp.ones((S,)), jnp.zeros((S,), jnp.int32))
    state, toks, n_acc = verify(params, state, jnp.asarray(plan["window"], jnp.int32),
                                jnp.asarray(plan["draft_len"], jnp.int32), active,
                                jax.random.PRNGKey(2), *greedy)
    out["verify"], out["verified"] = (np.asarray(toks), np.asarray(n_acc)), _copy(state)
    return out


@pytest.fixture(scope="module")
def jax_functions(np_params, plan):
    """JAX's outputs of each (mesh, layout), computed in a thread of their
    own while the engine tests run -> a function that joins it (within 120
    s) and returns them."""
    box = {}

    def work():
        try:
            box["out"] = {(kind, layout): _jax_functions(np_params, plan, kind, layout)
                          for kind in SPECS for layout in ("slot", "paged")}
        except BaseException as e:  # re-raised where the outputs are read
            box["err"] = e

    thread = threading.Thread(target=work, name="jax-references", daemon=True)
    thread.start()

    def join():
        thread.join(120)
        if "err" in box:
            raise box["err"]
        assert "out" in box, "JAX's references took more than 120 s"
        return box["out"]

    yield join
    thread.join(120)


def _assert_close(got, ref, what):
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, f"{what}: max|d| / max|ref| = {err}"


# -- the hop between stages ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pp2", "pp2tp2"])
def test_the_hop_between_stages(ranks, kind):
    """parallel.pipeline over each rank's "pp" group: stage 1 receives stage
    0's tensor, and every stage holds the last stage's after the broadcast."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for coord, got, last in ranks.run(tp_ranks.stage_hops, SPECS[kind], x):
        if coord[0] == 0:
            assert got is None
        else:
            np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(last, x + 1)


# -- a stage's weights and KV ----------------------------------------------------------------

@pytest.fixture(scope="module")
def stage_leaves(ranks, np_params, pt_params, tmp_path_factory):
    src = checkpoint.save_llama_params(pt_params, PT_CFG,
                                       str(tmp_path_factory.mktemp("pp") / "ckpt"))
    return {kind: ranks.run(tp_ranks.stage_leaves, SPECS[kind], np_params, "test-tiny", src)
            for kind in ("pp2", "pp2tp2")}


def _leaves(tree):
    for name, val in tree.items():
        for k, leaf in (val.items() if isinstance(val, dict) else [(None, val)]):
            for part, arr in (zip("qs", leaf) if hasattr(leaf, "q") else [("", leaf)]):
                yield f"{name}/{k}{part}", arr


@pytest.mark.parametrize("kind", ["pp2", "pp2tp2"])
@pytest.mark.parametrize("source", ["init", "int8", "checkpoint", "params"])
def test_each_stage_holds_only_its_layers(stage_leaves, kind, source):
    """The engine's weights on each stage rank (tp_worker.load_params from
    the seeded init, int8, a checkpoint directory and a whole parameter
    dict): every stacked layer leaf holds n_layers / 2 layers, the
    embedding, final norm and head are whole over pp (tp's cut only), the
    values are this stage's slice of the whole (bit for bit), and its
    bytes are its reckoned share."""
    tp = 2 if kind == "pp2tp2" else 1
    for out in stage_leaves[kind]:
        mine = out[source]
        shapes = mine["shapes"]
        assert shapes["layers"]["wq"] == (1, 64, 4 // tp, 16)
        assert shapes["layers"]["attn_norm"] == (1, 64)
        assert shapes["embed"] == (256 // tp, 64) and shapes["final_norm"] == (64,)
        assert shapes["lm_head"] == (64, 256 // tp)
        for (name, got), (_, want) in zip(_leaves(mine["got"]), _leaves(mine["want"])):
            np.testing.assert_array_equal(got, want, err_msg=f"{source} {name}")
        if source != "int8":
            per_layer = 4 * sum(int(np.prod(s)) for s in mine["shapes"]["layers"].values())
            rest = 4 * (2 * 64 * 256 // tp + 64)
            assert mine["bytes"] == per_layer + rest
            assert mine["bytes"] < mine["whole_bytes"]


@pytest.mark.parametrize("kind", ["pp2", "pp2tp2"])
def test_each_stage_holds_its_layers_kv_and_the_bridge_slices_alike(stage_leaves, kind):
    """A stage's slot cache, paged pool and prefill cache hold n_layers / 2
    layers (and tp's kv heads), and the bridge's shard of the JAX tree by
    infer_rules_for_mesh is the stage's slice of the whole."""
    kv = 2 // (2 if kind == "pp2tp2" else 1)
    for out in stage_leaves[kind]:
        assert out["caches"] == dict(slot=(1, 4, 64, kv, 16), paged=(1, 9, 16, kv, 16),
                                     prefill=(1, 1, 32, kv, 16))
        got, want = out["bridge"]
        for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a, b, err_msg=name)


# -- engines ---------------------------------------------------------------------------------

def _engine(pt_params, **kw):
    return TorchLLMEngine(LLMConfig(**{**COMMON, **kw}), params=pt_params, device="cpu")


def _at_once(fn, items):
    """fn(item) for every item, each on a thread of its own, all started at
    once -> the results in order."""
    outs = [None] * len(items)

    def run(i):
        outs[i] = fn(items[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    return outs


# the JAX references of the function checks compute meanwhile, and the
# ranks that run the port's side start
@pytest.mark.usefixtures("jax_functions", "ranks")
@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_serves_jax_greedy_ids(pt_params, jax_ids, caplog, layout, kind):
    """LLMConfig(pipeline_parallel_size=2) alone, with dp 2 and with tp 2, in
    each layout: JAX's greedy ids for test_paged_kv.py's prompts; paged,
    kv_block_size 16 and a 24-token decode across block boundaries; at dp 2
    four requests at once, decoded on both replicas. Every stage rank
    computed each prefill of its replica, and the default (auto) fused
    width is downgraded to per-step decode with one log line."""
    kw = dict(ENGINE_KW[kind])
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_size=16)
    eng = _engine(pt_params, **kw)
    try:
        with caplog.at_level(logging.INFO, logger=pt_engine.LOGGER.name):
            eng.start()
        assert len([r for r in caplog.records if "downgraded" in r.getMessage()]) == 1
        assert eng.decode_steps_target() == 1
        assert [eng.generate_sync(t, _greedy()).token_ids for t in TEXTS] == [
            jax_ids[t] for t in TEXTS]
        if layout == "paged":
            assert eng.generate_sync(LONG_TEXT, _greedy(24)).token_ids == jax_ids[LONG_TEXT]
        counts = eng.rank_counts(reset=True)
        assert sorted(c["stage"] for c in counts) == ([0, 0, 1, 1] if kind != "pp2" else [0, 1])
        for c in counts:  # each prefill ran on every stage of its replica
            owner = c["replica"] == 0
            assert c["prefills"] == (len(TEXTS) + (layout == "paged") if owner else 0)
        if kind == "pp2dp2":
            assert _at_once(lambda t: eng.generate_sync(t, _greedy()).token_ids,
                            list(TOGETHER)) == [jax_ids[t] for t in TOGETHER]
            assert all(c["active_steps"] > 0 and c["prefills"] > 0
                       for c in eng.rank_counts())
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [
    dict(pipeline_parallel_size=2),
    dict(pipeline_parallel_size=2, data_parallel_size=2),
    dict(pipeline_parallel_size=2, kv_layout="paged", kv_block_size=16),
    dict(pipeline_parallel_size=2, data_parallel_size=2, kv_layout="paged", kv_block_size=16)])
def test_spec_decode_through_pipeline_matches_greedy(pt_params, jax_ids, kw):
    """n-gram speculation (k = 4, one verify window a step: the fixed fused
    width 4 is downgraded) through the stages in both layouts, with and
    without dp: plain greedy, also with oracle drafts (all accepted) and
    adversarial ones (all rejected), as tests/test_llm.py:511-551."""
    want = jax_ids["spec"]
    eng = _engine(pt_params, max_model_len=64, num_speculative_tokens=4, num_decode_steps=4,
                  **kw)
    try:
        assert eng.generate_sync(SPEC_PROMPT, _greedy(12)).token_ids == want
        oracle = {tuple(SPEC_PROMPT + want[:i]): want[i:i + 4] for i in range(len(want))}
        eng._propose_ngram = lambda req, cap: list(oracle.get(tuple(req.token_history),
                                                              []))[:cap]
        assert eng.generate_sync(SPEC_PROMPT, _greedy(12)).token_ids == want
        assert eng.metrics()["num_spec_accepted"] >= 8
        assert eng.decode_steps_target() == 1
        eng._propose_ngram = lambda req, cap: [7] * cap
        assert eng.generate_sync(SPEC_PROMPT, _greedy(12)).token_ids == want
    finally:
        eng.shutdown()


def test_pd_under_pp_names_a6(pt_params):
    """P/D under pipeline parallelism is refused before anything starts."""
    eng = _engine(pt_params, pipeline_parallel_size=2)
    with pytest.raises(NotImplementedError, match="pipeline parallelism: ROADMAP A6"):
        eng.prefill_only([1, 2, 3], _greedy())
    with pytest.raises(NotImplementedError, match="pipeline parallelism: ROADMAP A6"):
        eng.generate_from_prefill({"prompt_ids": [1], "k": None, "v": None,
                                   "first_token": 1}, _greedy())
    assert eng._followers is None and not eng._started


# -- the _pp functions -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def functions(ranks, np_params, plan, jax_functions):
    """Each (mesh, layout)'s JAX outputs and every port rank's."""
    got = {}
    for kind, spec in SPECS.items():
        ids, appends = _paged_plan(JAX_SHAPES[kind][1])
        for layout in ("slot", "paged"):
            got[kind, layout] = ranks.run(tp_ranks.pp_functions, spec, np_params, "test-tiny",
                                          dict(plan, layout=layout, ids=ids, appends=appends))
    ref = jax_functions()
    return {key: (ref[key], got[key]) for key in got}


def _mine(ref, coord, kind, layout):
    """JAX's whole KV state cut to what the rank at `coord` holds: its
    stage's layers, its replica's slots (paged: its pool partition without
    the scratch block, its slots' tables) and its tp index's kv heads."""
    stage, replica, tp_index = coord[0], coord[1], coord[5]
    pp, dp, _, tp = JAX_SHAPES[kind]
    layers = slice(stage * (CFG.n_layers // pp), (stage + 1) * (CFG.n_layers // pp))
    kv = CFG.n_kv_heads // tp
    heads = slice(tp_index * kv, (tp_index + 1) * kv)
    rows = slice(replica * (S // dp), (replica + 1) * (S // dp))
    out = dict(lengths=ref["lengths"][rows])
    if layout == "paged":
        per = NUM_BLOCKS // dp
        blocks = slice(replica * (per + 1), replica * (per + 1) + per)
        out["tables"] = ref["block_tables"][rows]
    else:
        blocks = rows
    for name in ("k", "v"):
        out[name] = ref[name][layers, blocks, :, heads]
    return out


def _assert_kv(mine, ref, coord, kind, layout, what):
    want = _mine(ref, coord, kind, layout)
    for name in ("k", "v"):
        _assert_close(mine[name], want[name], f"{what} {name} at {coord}")
    for name in ("lengths", "tables") if layout == "paged" else ("lengths",):
        np.testing.assert_array_equal(mine[name], want[name], err_msg=f"{what} {name}")


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_staged_prefill_and_install_match_jax(functions, kind, layout):
    """Each prompt prefilled stage by stage on the replica that owns its
    slot (B1a's path: model_runner.prefill, or prefill_detached and
    PagedOps.install_prefill, then append_block): the last-token logits as
    JAX's one-device prefill, and every rank's layers, slots (or pool
    partition and tables) and kv heads as JAX's state."""
    ref, got = functions[kind, layout]
    per = S // JAX_SHAPES[kind][1]
    for out in got:
        for slot, first in enumerate(out["first"]):
            if slot // per == out["coord"][1]:
                _assert_close(first, ref["first"][slot], f"{kind} prefill {slot}")
            else:
                assert first is None
        _assert_kv(out["installed"], ref["installed"], out["coord"], kind, layout, "installed")


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_pp_decode_steps_match_jax(functions, kind, layout):
    """decode_step_pp / decode_step_paged_pp fed three steps with slot 3
    inactive (the 30-token prompt crossing into its appended block): the
    logits [S, V] of every replica on every rank within 1e-5 of max|ref|
    of JAX's, and every rank's KV as JAX's after them (the bubbles JAX
    discards or sends to scratch are never computed here)."""
    ref, got = functions[kind, layout]
    for out in got:
        _assert_close(out["steps"], ref["steps"], f"{kind} {layout} decode steps")
        _assert_kv(out["decoded"], ref["decoded"], out["coord"], kind, layout, "decoded")


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_pp_spec_verify_matches_jax(functions, kind, layout):
    """spec_verify_step_pp / spec_verify_step_paged_pp on a window with all,
    one and none of its drafts right: JAX's tokens and accepted counts on
    every rank, and its KV."""
    ref, got = functions[kind, layout]
    assert list(ref["verify"][1][:3]) == [2, 1, 0]
    for out in got:
        np.testing.assert_array_equal(out["verify"][0], ref["verify"][0])
        np.testing.assert_array_equal(out["verify"][1], ref["verify"][1])
        _assert_kv(out["verified"], ref["verified"], out["coord"], kind, layout, "verified")


# -- what the slice refuses ------------------------------------------------------------------

@pytest.mark.parametrize("kw,err,match", [
    (dict(pipeline_parallel_size=2, data_parallel_size=2, max_num_seqs=6), ValueError,
     r"max_num_seqs must divide by pp\*dp"),
    (dict(pipeline_parallel_size=2, max_num_seqs=3), ValueError,
     r"max_num_seqs must divide by pp\*dp"),
    (dict(pipeline_parallel_size=3, max_num_seqs=6), ValueError,
     "n_layers must divide by pipeline_parallel_size"),
    (dict(pipeline_parallel_size=2,
          model_source=dataclasses.replace(PT_CFG, scan_layers=False)), ValueError,
     "pipeline_parallel_size > 1 requires scan_layers"),
    (dict(pipeline_parallel_size=2, model_source="moe-tiny"), NotImplementedError,
     "ROADMAP A6"),
    (dict(pipeline_parallel_size=2, expert_parallel_size=2), NotImplementedError,
     "ROADMAP A6")])
def test_what_pipeline_parallelism_refuses(kw, err, match):
    with pytest.raises(err, match=match):
        LLMConfig(**{**COMMON, **kw})


def test_pp_devices_must_match_the_ranks():
    with pytest.raises(ValueError, match="3 devices for pipeline_parallel_size 2 × "
                                         "tensor_parallel_size 1 × data_parallel_size 2"):
        TorchLLMEngine(LLMConfig(pipeline_parallel_size=2, data_parallel_size=2),
                       devices=["cpu"] * 3)
