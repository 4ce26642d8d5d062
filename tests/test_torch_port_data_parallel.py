"""Port parity: data-parallel serving (``LLMConfig(data_parallel_size=N)``:
llm/paged.py's _ShardedBlockManager and _dp functions, model_runner's
over_replicas, the replicas of llm/tp_worker.py and the engine's
slot-scoped calls) against the JAX package at dp = 2, and dp 2 x tp 2, in
f32 on byte-tiny.

The JAX side runs on the host CPU devices that tests/conftest.py forces: its
jitted paged _dp functions on a ("dp", "ep", "tp") = (2, 1, 1) mesh, and on
a (2, 1, 2) mesh for dp x tp; the engines' reference ids come from its
jitted prefill / decode_step on one device, and for a MoE model from its
paged _dp functions, whose experts route each replica's tokens alone (see
test_moe_at_dp2_routes_each_replica_alone). No JAX engine is started. The
port side runs on one pool of 4 spawned gloo CPU ranks
(tests/_torch_tp_ranks.py): dp 2 x tp 2 as MeshSpec(dp=2, tp=2), and dp 2 at
tp 1 as MeshSpec(dp=2, fsdp=2), whose fsdp pairs are two copies of one dp 2
run (INFER_RULES cut no serving weight over fsdp). Each engine spawns its
own followers. Every wait is bounded: the groups time out after 60 s, and
every join and queue read has a timeout.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_tp_ranks as tp_ranks
from ray_tpu.llm import model_runner as jax_runner
from ray_tpu.llm import paged as jax_paged
from ray_tpu.models import config as jax_config
from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine
from ray_tpu_torch.llm import config as pt_llm_config
from ray_tpu_torch.llm import engine as pt_engine
from ray_tpu_torch.llm import paged as pt_paged
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.parallel import MeshSpec

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

TOL = 1e-5  # relative to max|ref|: f32 on both sides, the sums in other orders
CFG = jax_config.get_config("byte-tiny")
PT_CFG = pt_config.get_config("byte-tiny")
DP = 2
SPECS = {"dp2": MeshSpec(dp=2, fsdp=2), "dp2tp2": MeshSpec(dp=2, tp=2)}
JAX_SHAPES = {"dp2": (2, 1, 1), "dp2tp2": (2, 1, 2)}
S, MAX_LEN, BS, NUM_BLOCKS, BUCKET = 4, 64, 16, 16, 32  # 2 slots, 8 blocks a replica
PROMPTS = [[1, 7, 42, 99, 5, 6, 200, 3, 11, 9, 8, 77, 12, 13, 14, 15, 16, 300, 301, 302],
           [1, 3, 3, 300, 9, 4, 4, 4, 2],
           [1] + list(range(100, 126)),
           [1, 50, 51, 52, 50, 51, 52, 50, 51, 52, 50, 51, 52, 60, 61, 62, 63]]
GREEDY = 12  # tokens a reference request generates
REPEAT = list(range(200, 240))  # two full blocks and 8 tokens
# the function checks: replica-local block ids a slot's prompt takes, the
# decode block appended to each slot's table, fed decode steps, a fused
# burst with replica 1 idle, k = 2 speculation over P + C + P prompts
PLAN = dict(max_len=MAX_LEN, bs=BS, num_blocks=NUM_BLOCKS, bucket=BUCKET,
            ids=[[4, 1], [0, 5], [2, 3], [5, 0]], appends=[(2, 2), (2, 3), (2, 1), (2, 4)],
            burst=4, burst_active=[True, True, False, False], spec=(2, 2, 3),
            cached=[2], new_ids=[6], warm_slot=3)
N_FED = 3
# the meshes the speculative functions are checked on (the dp 2 x tp 2
# engine runs them too, against JAX's ids)
SPEC_KINDS = ["dp2"]
# MoE at dp 2: 8 slots a replica, so a decode step routes 8 tokens (16
# picks, top-2) per replica into 4 experts of capacity 4 at this factor
# (moe.expert_capacity: at most 4 tokens a group never drop), and 16 tokens
# into capacity 5 over both replicas: capacity binds either way
MOE_CFG = dataclasses.replace(jax_config.get_config("moe-tiny"), moe_capacity_factor=0.5)
PT_MOE_CFG = dataclasses.replace(pt_config.get_config("moe-tiny"), moe_capacity_factor=0.5)
MOE_S, MOE_GEN = 16, 8
MOE_PROMPTS = [[1] + [int(t) for t in row]
               for row in np.random.RandomState(0).randint(2, 256, (MOE_S, 3))]
# the slot of each prompt: the replicas alternate, as an engine admitting
# them in one cycle places them (TorchLLMEngine._next_free_slot)
MOE_SLOTS = [i // 2 + MOE_S // DP * (i % 2) for i in range(MOE_S)]


def _greedy(max_tokens=GREEDY):
    return SamplingParams(max_tokens=max_tokens, temperature=0.0, stop_token_ids=[-1])


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def pt_params(np_params):
    return bridge.params_from_jax(np_params, PT_CFG, device="cpu")


@pytest.fixture(scope="module")
def ranks():
    r = tp_ranks.Ranks(4, SPECS["dp2tp2"])
    yield r
    r.close()


def _jax_mesh(kind):
    shape = JAX_SHAPES[kind]
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("dp", "ep", "tp"))


def _jax_greedy_ids(params, mesh, prompt, n=GREEDY):
    """JAX's prefill into slot 0, then decode_step n - 1 times, greedy."""
    state = jax_runner.init_state(CFG, 1, MAX_LEN, mesh)
    bucket = max(16, 1 << (len(prompt) - 1).bit_length())
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :len(prompt)] = prompt
    state, last = jax_runner.prefill(params, state, jnp.asarray(tokens),
                                     jnp.int32(len(prompt)), jnp.int32(0), CFG)
    ids = [int(np.argmax(np.asarray(last)))]
    for _ in range(n - 1):
        state, lg = jax_runner.decode_step(params, state, jnp.asarray([ids[-1]], jnp.int32),
                                           jnp.asarray([True]), CFG)
        ids.append(int(np.argmax(np.asarray(lg[0]))))
    return ids


@pytest.fixture(scope="module")
def jax_ids(np_params):
    """JAX's greedy ids for PROMPTS and for P + C + P (C: P's own greedy
    continuation, so a speculative engine drafts)."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "ep", "tp"))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = {"prompts": [_jax_greedy_ids(params, mesh, p) for p in PROMPTS]}
    out["spec_prompts"] = [p[:9] + c[:8] + p[:9] for p, c in zip(PROMPTS, out["prompts"])]
    out["spec"] = [_jax_greedy_ids(params, mesh, q, 16) for q in out["spec_prompts"]]
    return out


def _jax_moe_ids(np_params):
    """JAX's greedy ids for MOE_PROMPTS in MOE_SLOTS on a (2, 1, 1) mesh:
    "replica" through the paged _dp functions (install_prefill_dp,
    decode_step_paged_dp: a shard_map, each replica's experts route its own
    slots' tokens), "global" through the slot layout's GSPMD decode_step,
    whose experts route all 16 slots' tokens as one group."""
    mesh = _jax_mesh("dp2")
    params = jax_runner.shard_params(np_params, MOE_CFG, mesh)
    per = MOE_S // DP
    tokens = [np.zeros((1, 16), np.int32) for _ in MOE_PROMPTS]
    for t, p in zip(tokens, MOE_PROMPTS):
        t[0, :len(p)] = p
    active = jnp.ones((MOE_S,), bool)
    out = {}
    for kind in ("replica", "global"):
        if kind == "replica":
            state = jax_paged.init_paged_state(MOE_CFG, MOE_S, MAX_LEN, 2 * MOE_S, BS, mesh)
        else:
            state = jax_runner.init_state(MOE_CFG, MOE_S, MAX_LEN, mesh)
        ids = [None] * MOE_S
        for prompt, t, slot in zip(MOE_PROMPTS, tokens, MOE_SLOTS):
            n = jnp.int32(len(prompt))
            if kind == "replica":
                k, v, last = jax_runner.prefill_detached(params, jnp.asarray(t), n, MOE_CFG)
                state = jax_paged.install_prefill_dp(
                    state, k, v, jnp.asarray([slot % per], jnp.int32), n, jnp.int32(slot),
                    n_blocks=1, mesh=mesh, slots_per=per)
            else:
                state, last = jax_runner.prefill(params, state, jnp.asarray(t), n,
                                                 jnp.int32(slot), MOE_CFG)
            ids[slot] = [int(np.argmax(np.asarray(last)))]
        for _ in range(MOE_GEN - 1):
            feed = jnp.asarray([i[-1] for i in ids], jnp.int32)
            if kind == "replica":
                state, lg = jax_paged.decode_step_paged_dp(params, state, feed, active,
                                                           MOE_CFG, mesh)
            else:
                state, lg = jax_runner.decode_step(params, state, feed, active, MOE_CFG)
            for i, row in zip(ids, np.asarray(lg)):
                i.append(int(row.argmax()))
        out[kind] = [ids[slot] for slot in MOE_SLOTS]  # by prompt
    return out


def _copy(state):
    """A numpy copy of a JAX PagedState (the next call donates it)."""
    return {name: np.array(getattr(state, name)) for name in ("k", "v", "block_tables",
                                                              "lengths")}


def _jax_installed(params, mesh, prompts):
    state = jax_paged.init_paged_state(CFG, S, MAX_LEN, NUM_BLOCKS, BS, mesh)
    first = []
    for slot, (prompt, ids) in enumerate(zip(prompts, PLAN["ids"])):
        tokens = np.zeros((1, BUCKET), np.int32)
        tokens[0, :len(prompt)] = prompt
        k, v, last = jax_runner.prefill_detached(params, jnp.asarray(tokens),
                                                 jnp.int32(len(prompt)), CFG)
        state = jax_paged.install_prefill_dp(state, k, v, jnp.asarray(ids, jnp.int32),
                                             jnp.int32(len(prompt)), jnp.int32(slot),
                                             n_blocks=len(ids), mesh=mesh, slots_per=S // DP)
        first.append(np.asarray(last))
    for slot, (index, bid) in enumerate(PLAN["appends"]):
        state = jax_paged.append_block_dp(state, jnp.int32(slot), jnp.int32(index),
                                          jnp.int32(bid), mesh=mesh, slots_per=S // DP)
    return state, np.stack(first)


@pytest.fixture(scope="module")
def plan(jax_ids):
    """PLAN with its token inputs: decode steps fed greedy ids, the burst's
    start, the speculative prompts and a verify window, the warm path's
    suffix behind slot 2's first (cached) block."""
    plan = dict(PLAN, prompts=PROMPTS, spec_prompts=jax_ids["spec_prompts"])
    ids = jax_ids["prompts"]
    plan["feed"] = [[ids[s][t] for s in range(S)] for t in range(N_FED)]
    plan["burst_from"] = [ids[s][N_FED] for s in range(S)]
    spec = jax_ids["spec"]
    # a token, then up to two drafts from the P + C + P continuation, some
    # replaced by wrong ones
    plan["window"] = [[spec[0][0], spec[0][1], spec[0][2]], [spec[1][0], spec[1][1], 5],
                      [spec[2][0], 7, 7], [spec[3][0], spec[3][1], spec[3][2]]]
    plan["draft_len"] = [2, 2, 2, 1]
    plan["suffix"] = [400, 401, 402, 403, 404]
    plan["warm_len"] = BS + len(plan["suffix"])
    plan["row"] = [PLAN["cached"][0], PLAN["new_ids"][0]] + [0] * (MAX_LEN // BS - 2)
    return plan


def _jax_functions(np_params, plan, kind):
    """The JAX package's _dp functions in dp_functions' order, on its mesh."""
    mesh = _jax_mesh(kind)
    params = jax_runner.shard_params(np_params, CFG, mesh)
    out = {}
    state, out["first"] = _jax_installed(params, mesh, plan["prompts"])
    out["appended"] = _copy(state)
    active = jnp.ones((S,), bool)
    greedy = (jnp.zeros((S,)), jnp.ones((S,)), jnp.zeros((S,), jnp.int32))
    steps = []
    for row in plan["feed"]:
        state, lg = jax_paged.decode_step_paged_dp(params, state, jnp.asarray(row, jnp.int32),
                                                   active, CFG, mesh)
        steps.append(np.asarray(lg))
    out["steps"], out["decoded"] = np.stack(steps), _copy(state)
    n = plan["burst"]
    state, toks = jax_paged.decode_multi_paged_dp(
        params, state, jnp.asarray(plan["burst_from"], jnp.int32),
        jnp.asarray(plan["burst_active"]), CFG, jax.random.split(jax.random.PRNGKey(0), n),
        *greedy, jnp.full((S,), n, jnp.int32), mesh=mesh)
    out["burst"], out["bursted"] = np.asarray(toks), _copy(state)

    state, _ = _jax_installed(params, mesh, plan["spec_prompts"])
    if kind in SPEC_KINDS:
        hist = np.zeros((S, MAX_LEN), np.int32)
        for slot, q in enumerate(plan["spec_prompts"]):
            hist[slot, :len(q)] = q
        hlen = jnp.asarray([len(q) for q in plan["spec_prompts"]], jnp.int32)
        m, k, nmax = plan["spec"]
        state, *multi = jax_paged.spec_multi_paged_dp(
            params, state, jnp.asarray(hist), hlen, active, CFG,
            jax.random.split(jax.random.PRNGKey(1), m), *greedy, m=m, k=k, nmax=nmax,
            mesh=mesh)
        out["multi"], out["multied"] = [np.asarray(t) for t in multi], _copy(state)
        state, toks, n_acc = jax_paged.spec_verify_step_paged_dp(
            params, state, jnp.asarray(plan["window"], jnp.int32),
            jnp.asarray(plan["draft_len"], jnp.int32), active, CFG, jax.random.PRNGKey(2),
            *greedy, mesh=mesh)
        out["verify"], out["verified"] = (np.asarray(toks), np.asarray(n_acc)), _copy(state)

    suffix = np.zeros((1, BS), np.int32)
    suffix[0, :len(plan["suffix"])] = plan["suffix"]
    warm = jax_paged.prefill_suffix_from_state_dp(
        params, state, jnp.asarray(plan["cached"], jnp.int32), jnp.asarray(suffix),
        jnp.int32(len(plan["suffix"])), CFG, n_blocks=len(plan["cached"]), mesh=mesh,
        slots_per=S // DP, slot=jnp.int32(plan["warm_slot"]))
    out["warm"] = [np.asarray(t) for t in warm]
    state = jax_paged.install_with_prefix_dp(
        state, warm[0], warm[1], jnp.asarray(plan["new_ids"], jnp.int32),
        jnp.asarray(plan["row"], jnp.int32), jnp.int32(plan["warm_len"]),
        jnp.int32(plan["warm_slot"]), n_new=len(plan["new_ids"]), mesh=mesh,
        slots_per=S // DP)
    out["warmed"] = _copy(state)
    return out


@pytest.fixture(scope="module")
def jax_functions(np_params, plan):
    """JAX's outputs of each mesh kind, computed in a thread of their own
    while the engine tests run (their compiles are most of this file's
    time) -> a function that joins it (within 120 s) and returns them."""
    box = {}

    def work():
        try:
            out = {kind: _jax_functions(np_params, plan, kind) for kind in SPECS}
            out["moe"] = _jax_moe_ids(numpy_params(MOE_CFG))
            box["out"] = out
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


@pytest.fixture(scope="module")
def functions(ranks, np_params, plan, jax_functions):
    """Each mesh kind's JAX outputs and every port rank's."""
    got = {kind: ranks.run(tp_ranks.dp_functions, SPECS[kind], np_params, "byte-tiny",
                           dict(plan, with_spec=kind in SPEC_KINDS)) for kind in SPECS}
    ref = jax_functions()
    return {kind: (ref[kind], got[kind]) for kind in SPECS}


@pytest.fixture(scope="module")
def jax_moe(jax_functions):
    """JAX's MoE ids (_jax_moe_ids), computed in jax_functions' thread."""
    return jax_functions()["moe"]


def _assert_close(got, ref, what):
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, f"{what}: max|d| / max|ref| = {err}"


def _partition(whole, replica, tp_index, tp):
    """JAX's pool partition of one replica (its scratch block dropped) at
    one tp index's kv heads, from the whole [L, NB + dp, ...] pool."""
    per = NUM_BLOCKS // DP
    kv = whole.shape[3] // tp
    return whole[:, replica * (per + 1):replica * (per + 1) + per, :,
                 tp_index * kv:(tp_index + 1) * kv]


def _assert_pool(mine, ref, coord, what):
    """A rank's partition, tables and lengths against JAX's at its (dp, tp)
    coordinate."""
    replica, tp_index = coord[1], coord[5]
    tp = 2 if ref["k"].shape[3] != mine["k"].shape[3] else 1
    rows = slice(replica * (S // DP), (replica + 1) * (S // DP))
    for name in ("k", "v"):
        _assert_close(mine[name], _partition(ref[name], replica, tp_index, tp),
                      f"{what} {name} at {coord}")
    np.testing.assert_array_equal(mine["tables"], ref["block_tables"][rows], err_msg=what)
    np.testing.assert_array_equal(mine["lengths"], ref["lengths"][rows], err_msg=what)


# -- the block manager -----------------------------------------------------------------------

def test_sharded_block_manager_follows_jax_s_step_by_step():
    """One sequence of operations on both managers (8 blocks of 4 tokens,
    4 slots, dp 2): the same replica-local ids, free counts, hits per
    replica, same_pool and max_fit; the aggregate hit_tokens setter raises."""
    ours = pt_paged.make_block_manager(8, 4, 6, 4, dp=DP)
    theirs = jax_paged.make_block_manager(8, 4, 6, 4, dp=DP)
    assert type(ours).__name__ == type(theirs).__name__ == "_ShardedBlockManager"
    prompt = list(range(1, 14))  # 3 full blocks + 1 token

    def both(fn):
        a, b = fn(ours), fn(theirs)
        assert a == b, (a, b)
        return a

    both(lambda m: m.allocate(0, 4))
    both(lambda m: m.register_blocks(0, prompt, m.owned_for(0), 0))
    both(lambda m: m.allocate(2, 2))
    both(lambda m: [m.num_free_for(s) for s in range(4)] + [m.num_free, m.total_blocks])
    assert both(lambda m: [m.can_allocate_for(s, 1) for s in range(4)]) == [False, False,
                                                                           True, True]
    both(lambda m: m.release(0))
    # the same prompt hits in replica 0 (slot 1), and not in replica 1 (slot 3)
    assert both(lambda m: m.match_prefix(1, prompt)) != []
    assert both(lambda m: m.match_prefix(3, prompt)) == []
    for m in (ours, theirs):
        m.add_hit_tokens(1, 8)
    both(lambda m: [m.hit_tokens, [s.hit_tokens for s in m.subs], sorted(m.cached.items())])
    both(lambda m: [m.same_pool(a, b) for a in range(4) for b in range(4)])
    both(lambda m: [m.max_fit(s) for s in range(4)] + [m.slot_capacity(s) for s in range(4)])
    both(lambda m: m.allocate(1, 2))
    both(lambda m: [m.owned_for(s) for s in range(4)])
    for m in (ours, theirs):
        with pytest.raises(AttributeError, match="add_hit_tokens"):
            m.hit_tokens = 3


# -- engines ---------------------------------------------------------------------------------

def _engine(pt_params, **kw):
    base = dict(model_source="byte-tiny", dtype="float32", max_num_seqs=S,
                max_model_len=MAX_LEN)
    return TorchLLMEngine(LLMConfig(**{**base, **kw}), params=pt_params, device="cpu")


def _together(eng, prompts, params):
    """Every prompt submitted at once (threads) -> the ids of each."""
    return _at_once(lambda p: eng.generate_sync(p, params).token_ids, prompts)


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
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return outs


def _replicas_decoded(eng):
    """Each rank's (replica, prefills, decode steps with an active slot)."""
    return [(c["replica"], c["prefills"], c["active_steps"]) for c in eng.rank_counts()]


# the paged engines: 8 blocks of 8 tokens a replica, one slot's width, so
# two requests in one replica preempt each other
PAGED = dict(kv_layout="paged", kv_block_size=8, num_kv_blocks=16)
SPEC = dict(num_decode_steps=4, num_speculative_tokens=3)


# the JAX references of the function checks below compute meanwhile, and
# the ranks that run the port's side start
@pytest.mark.usefixtures("jax_functions", "ranks")
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_serves_jax_greedy_ids(pt_params, jax_ids, monkeypatch, layout, tp):
    """LLMConfig(data_parallel_size=2) in each layout, alone and at tp 2 (4
    ranks): JAX's greedy ids, sequential at tp 1 (and, paged, from two P/D
    transfers at once), then four requests at once
    (both replicas decoding). The paged engines (test_paged_kv.py:290-393)
    run fused bursts and n-gram speculation, their four requests P + C + P
    in a pool that makes each replica preempt among its own requests, and a
    repeat that hits the prefix cache of the replica that served the first."""
    monkeypatch.setattr(pt_llm_config, "PREFIX_MIN_HIT_TOKENS", 1)
    kw = dict(PAGED, **SPEC) if layout == "paged" else dict(num_decode_steps=4)
    eng = _engine(pt_params, data_parallel_size=DP, tensor_parallel_size=tp, **kw)
    try:
        want = jax_ids["prompts"]
        if tp == 1:
            assert [eng.generate_sync(p, _greedy()).token_ids for p in PROMPTS[:2]] == want[:2]
        if tp == 1 and layout == "paged":
            # P/D: two transfers at once, each installed by the replica that
            # owns its slot
            pre = _engine(pt_params, **kw)
            sent = [pre.prefill_only(p, _greedy()) for p in PROMPTS[2:]]
            assert _at_once(lambda r: [t for out in eng.generate_from_prefill(r, _greedy())
                                       for t in out.token_ids], sent) == want[2:]
        eng.rank_counts(reset=True)
        if layout == "slot":
            assert _together(eng, PROMPTS, _greedy()) == want
        else:
            assert _together(eng, jax_ids["spec_prompts"], _greedy(16)) == jax_ids["spec"]
            metrics = eng.metrics()
            assert metrics["num_spec_drafted"] > 0 and metrics["num_preemptions"] > 0
        counts = _replicas_decoded(eng)
        assert len(counts) == DP * tp and all(steps > 0 for _, _, steps in counts)
        if layout == "paged":
            # alone, a prompt goes to slot 0 (the replicas' free blocks tie),
            # and so does its repeat, which hits that replica's cache
            first = eng.generate_sync(REPEAT, _greedy()).token_ids
            hits = [sub.hit_tokens for sub in eng._blocks.subs]
            assert eng.generate_sync(REPEAT, _greedy()).token_ids == first
            more = [sub.hit_tokens for sub in eng._blocks.subs]
            assert more[0] > hits[0] and more[1] == hits[1]
            assert type(eng._blocks).__name__ == "_ShardedBlockManager"
    finally:
        eng.shutdown()


def test_the_victim_is_the_youngest_of_the_growing_slot_s_pool():
    """The scheduler alone (no device call): replica 0's pool is full and
    slot 0 needs a block; replica 1 holds the youngest request. The victim
    is replica 0's youngest (slot 1), never replica 1's."""
    eng = TorchLLMEngine(LLMConfig(model_source="byte-tiny", max_num_seqs=4, max_model_len=64,
                                   kv_layout="paged", kv_block_size=8, num_kv_blocks=8,
                                   data_parallel_size=DP), device="cpu")
    eng._blocks = pt_paged.make_block_manager(8, 8, 8, 4, dp=DP)
    eng._active = dict.fromkeys(range(4))
    calls = []
    eng._run = lambda op, *args: calls.append((op, args))
    reqs = {}
    for slot, (n, age) in {0: (16, 1), 1: (16, 2), 2: (8, 3)}.items():
        req = pt_engine._Request(f"r{slot}", list(range(1, n)), _greedy(40))
        req.slot, req.admitted_at, req.generated = slot, age, 1
        eng._blocks.allocate(slot, 2)
        eng._active[slot], reqs[slot] = req, req
    eng._grow_or_preempt(headroom=4)
    assert eng._active[1] is None and reqs[1].slot == -1  # replica 0's youngest
    assert eng._active[2] is reqs[2]  # the youngest overall, in replica 1, stays
    assert eng._active[0] is reqs[0] and [c[1][:2] for c in calls] == [(0, 2)]
    assert eng.num_preemptions == 1


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_moe_at_dp2_routes_each_replica_alone(ranks, jax_moe, layout):
    """moe-tiny at data_parallel_size 2 (each replica runs the whole model):
    a replica's experts route its own slots' tokens, so their capacity comes
    from max_num_seqs / 2 tokens, as in JAX's paged _dp functions (a
    shard_map per replica). JAX's slot layout at dp 2 is one GSPMD program
    whose experts route all slots' tokens as one group; where capacity binds
    the two differ, and the port's slot layout keeps to the per-replica rule
    as its paged layout does. The engine's ShardRunner on every rank, 16
    prompts prefilled into the slots an engine admitting them together
    gives them, 8 a replica, then a greedy burst with capacity binding:
    JAX paged dp's ids in both layouts, on every rank."""
    assert jax_moe["replica"] != jax_moe["global"]  # capacity binds
    kw = dict(max_num_seqs=MOE_S, max_model_len=MAX_LEN, data_parallel_size=DP)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_size=BS, num_kv_blocks=2 * MOE_S)
    got = ranks.run(tp_ranks.runner_ids, SPECS["dp2"], numpy_params(MOE_CFG), PT_MOE_CFG, kw,
                    MOE_PROMPTS, MOE_SLOTS, MOE_GEN)
    for ids in got:
        assert ids == jax_moe["replica"]


def _admitted_together(eng, prompts, params):
    """Every prompt queued while the engine's device calls are held, so that
    one admission cycle takes them all, in queue order, before the first
    decode step -> (each prompt's ids, the slot each was admitted to)."""
    eng.start()
    slots = {}
    step = eng._step_decode

    def first_step():
        if not slots:
            slots.update({r.id: s for s, r in eng._active.items() if r is not None})
        step()

    eng._step_decode = first_step
    reqs = [pt_engine._Request(f"together-{i}", list(p), params) for i, p in enumerate(prompts)]
    with eng._run_lock:
        streams = [eng._submit(r) for r in reqs]
    ids = [[t for out in stream for t in out.token_ids] for stream in streams]
    return ids, [slots.get(r.id) for r in reqs]


def test_moe_engine_at_dp2_serves_jax_paged_dp_ids(jax_moe):
    """The paged engine at data_parallel_size 2 on moe-tiny, fused bursts
    of 4: the 16 prompts admitted in one cycle take MOE_SLOTS (the replicas
    alternate) and are served JAX paged dp's greedy ids, capacity binding
    in each replica's decode steps."""
    params = bridge.params_from_jax(numpy_params(MOE_CFG), PT_MOE_CFG, device="cpu")
    eng = TorchLLMEngine(LLMConfig(model_source=PT_MOE_CFG, dtype="float32",
                                   max_num_seqs=MOE_S, max_model_len=MAX_LEN,
                                   num_decode_steps=4, data_parallel_size=DP,
                                   kv_layout="paged", kv_block_size=BS,
                                   num_kv_blocks=2 * MOE_S),
                         params=params, device="cpu")
    try:
        ids, slots = _admitted_together(eng, MOE_PROMPTS, _greedy(MOE_GEN))
        assert slots == MOE_SLOTS
        assert ids == jax_moe["replica"]
        assert all(steps > 0 for _, _, steps in _replicas_decoded(eng))
    finally:
        eng.shutdown()


# -- the _dp functions -----------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(SPECS))
def test_dp_installs_and_append_match_jax(functions, kind):
    """install_prefill_dp on the owning replica only (replica-local ids;
    JAX redirects a non-owner's copy into its scratch block) and
    append_block_dp: every rank's partition, tables and lengths as JAX's."""
    ref, got = functions[kind]
    for out in got:
        _assert_close(out["first"], ref["first"], f"{kind} prefill")
        _assert_pool(out["appended"], ref["appended"], out["coord"], f"{kind} installs")


@pytest.mark.parametrize("kind", list(SPECS))
def test_dp_decode_step_and_greedy_burst_match_jax(functions, plan, kind):
    """decode_step_paged_dp's logits [S, V] of both replicas, then a greedy
    decode_multi_paged_dp burst with replica 1 idle (its tokens kept, its
    partition untouched): within 1e-5 of max|ref| on every rank."""
    ref, got = functions[kind]
    for out in got:
        _assert_close(out["steps"], ref["steps"], f"{kind} decode steps")
        _assert_pool(out["decoded"], ref["decoded"], out["coord"], f"{kind} decode")
        np.testing.assert_array_equal(out["burst"], ref["burst"])
        _assert_pool(out["bursted"], ref["bursted"], out["coord"], f"{kind} burst")
    assert (ref["burst"][:, 2:] == np.asarray(plan["burst_from"][2:])).all()


@pytest.mark.parametrize("kind", SPEC_KINDS)
def test_dp_spec_multi_and_verify_match_jax(functions, kind):
    """spec_multi_paged_dp (m 2, k 2, drafts proposed on the device over
    P + C + P) and spec_verify_step_paged_dp: the same tokens, accepted
    and drafted counts, and partitions."""
    ref, got = functions[kind]
    assert ref["multi"][2].sum() > 0  # something was drafted
    for out in got:
        for mine, theirs, name in zip(out["multi"], ref["multi"], ("toks", "acc", "drafted")):
            np.testing.assert_array_equal(mine, theirs, err_msg=name)
        _assert_pool(out["multied"], ref["multied"], out["coord"], f"{kind} spec_multi")
        np.testing.assert_array_equal(out["verify"][0], ref["verify"][0])
        np.testing.assert_array_equal(out["verify"][1], ref["verify"][1])
        _assert_pool(out["verified"], ref["verified"], out["coord"], f"{kind} verify")


@pytest.mark.parametrize("kind", list(SPECS))
def test_dp_warm_path_and_install_with_prefix_match_jax(functions, kind):
    """prefill_suffix_from_state_dp over slot 2's cached block, on the
    owning replica alone (JAX psums the owner's blocks and computes on
    every replica), then install_with_prefix_dp into slot 3."""
    ref, got = functions[kind]
    for out in got:
        replica = out["coord"][1]
        if replica != PLAN["warm_slot"] // (S // DP):
            assert out["warm"] is None
        else:
            k, v, last = out["warm"]
            _assert_close(last, ref["warm"][2], f"{kind} warm logits")
            tp = CFG.n_kv_heads // k.shape[3]
            t = out["coord"][5]
            for name, mine, theirs in (("k", k, ref["warm"][0]), ("v", v, ref["warm"][1])):
                kv = theirs.shape[3] // tp
                _assert_close(mine, theirs[:, :, :, t * kv:(t + 1) * kv], f"{kind} warm {name}")
        _assert_pool(out["warmed"], ref["warmed"], out["coord"], f"{kind} install_with_prefix")


@pytest.mark.parametrize("kind,config_kw", [
    ("dp2", dict(data_parallel_size=2)),
    ("dp2tp2", dict(data_parallel_size=2, tensor_parallel_size=2, kv_layout="paged",
                    kv_block_size=BS, num_kv_blocks=NUM_BLOCKS))])
def test_replicas_draw_apart_and_tp_ranks_alike(ranks, np_params, kind, config_kw):
    """The engine's ShardRunner at temperature 1, the same prompt in every
    slot: each replica samples from a generator of its own (JAX folds the
    dp index into its keys), so the two replicas' draws differ, while the
    tp ranks of a replica draw alike and every rank holds the same gathered
    tokens."""
    kw = dict(max_num_seqs=S, max_model_len=MAX_LEN, **config_kw)
    got = ranks.run(tp_ranks.runner_draws, SPECS[kind], np_params, "byte-tiny", kw,
                    PROMPTS[1], 6, 1.0)
    toks = [t for _, _, t in got]
    for t in toks[1:]:
        np.testing.assert_array_equal(t, toks[0])
    per = S // DP
    assert not np.array_equal(toks[0][:, :per], toks[0][:, per:])
    firsts = {coord: first for coord, first, _ in got}
    rank0 = firsts[(0,) * 6]
    assert None not in rank0 and rank0[:per] != rank0[per:]


# -- what the slice does not serve ---------------------------------------------------------

@pytest.mark.parametrize("kw,err,match", [
    (dict(data_parallel_size=2, expert_parallel_size=2), NotImplementedError, "ROADMAP A6"),
    (dict(data_parallel_size=2, pipeline_parallel_size=2, model_source="moe-tiny"),
     NotImplementedError, "ROADMAP A6"),
    (dict(data_parallel_size=2, tensor_parallel_size=2, model_source="moe-tiny"),
     NotImplementedError, "ROADMAP A6"),
    (dict(data_parallel_size=3), ValueError,
     "max_num_seqs must be divisible by data_parallel_size"),
    (dict(data_parallel_size=2, kv_layout="paged", num_kv_blocks=9), ValueError,
     r"num_kv_blocks \(9\) must divide by data_parallel_size \(2\)"),
    (dict(data_parallel_size=2, kv_layout="paged", max_num_seqs=2, max_model_len=64,
          kv_block_size=16, num_kv_blocks=None, prefill_buckets=[16, 64]), None, None)])
def test_what_data_parallelism_refuses(kw, err, match):
    if err is None:  # the default pool, 2 x 64 / 16 = 8 blocks, divides
        assert LLMConfig(**kw).kv_pool_blocks() == 8
        return
    with pytest.raises(err, match=match):
        LLMConfig(**kw)


def test_dp_devices_must_match_the_ranks():
    with pytest.raises(ValueError, match="3 devices for tensor_parallel_size 1 × "
                                         "data_parallel_size 2"):
        TorchLLMEngine(LLMConfig(data_parallel_size=2), devices=["cpu"] * 3)
