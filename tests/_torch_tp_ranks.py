"""Port ranks for the mesh parity tests: N spawned CPU processes joined in a
gloo mesh (tp = N unless a MeshSpec is given), each running the jobs the
test process sends it and sending back what it got. A job may lay another
mesh over the same N ranks (``mesh_of``). The jobs import the port only (no
JAX): a rank is a fresh interpreter, and JAX stays in the test process.

Every wait is bounded: a job that does not answer within the timeout, or a
rank that dies, fails the test that sent it; ``close`` joins each rank with
a timeout and kills what is left.
"""
import copy
import multiprocessing
import queue
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.llm import model_runner, paged
from ray_tpu_torch.models import bridge, checkpoint, llama
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.ops.quant import quantize_llama_params
from ray_tpu_torch.parallel import (INFER_RULES, TRAIN_RULES, MeshSpec, axis_index, build_mesh,
                                    shard_leaf, shard_pytree, shard_view)
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.train import optim
from ray_tpu_torch.train import step as train_step

TIMEOUT_S = 60.0  # the groups' own bound (parallel.mesh.GROUP_TIMEOUT_S)


def _rank_main(rank, n, spec, init_method, inbox, outbox):
    torch.set_num_threads(1)
    try:
        mesh = build_mesh(spec, ["cpu"] * n, rank=rank, init_method=init_method)
        while True:
            job = inbox.get()
            if job is None:
                break
            fn, args = job
            try:
                outbox.put((rank, "ok", fn(mesh, *args)))
            except Exception:
                outbox.put((rank, "err", traceback.format_exc()))
        dist.destroy_process_group()
    except Exception:
        outbox.put((rank, "err", traceback.format_exc()))


class Ranks:
    """N port ranks (spawned once) on a mesh of `spec` (MeshSpec(tp=n) by
    default); ``run(fn, *args)`` -> each rank's result."""

    def __init__(self, n=2, spec=None):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, n, spec or MeshSpec(tp=n),
                                        f"tcp://127.0.0.1:{port}", self.inboxes[r], self.outbox))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        for box in self.inboxes:
            box.put((fn, args))
        got = {}
        for _ in self.procs:
            try:
                rank, status, out = self.outbox.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(f"no answer from the ranks within {TIMEOUT_S} s") from None
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        return [got[r] for r in range(len(self.procs))]

    def close(self):
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(TIMEOUT_S / 4)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        assert not any(p.is_alive() for p in self.procs)


# -- jobs: fn(mesh, *args) on every rank ------------------------------------------------

def _params(np_params, cfg_name, int8=False):
    cfg = get_config(cfg_name)
    params = bridge.params_from_jax(np_params, cfg, device="cpu")
    return cfg, quantize_llama_params(params) if int8 else params


def shards(mesh, np_params, cfg_name, jax_int8=None):
    """This rank's shard of every leaf (numpy): the port's own, by
    shard_params (quantized whole first when `jax_int8` is given), and the
    bridge's shard of a JAX tree (`jax_int8`, else np_params)."""
    cfg, params = _params(np_params, cfg_name, jax_int8 is not None)
    bridged = bridge.params_from_jax(np_params if jax_int8 is None else jax_int8, cfg,
                                     device="cpu", mesh=mesh)
    return (bridge.params_to_numpy(model_runner.shard_params(params, cfg, mesh)),
            bridge.params_to_numpy(bridged))


def seeded_shards(mesh, cfg_name, int8):
    """llama.init's shards with the mesh, and shard_params of the whole init."""
    cfg = get_config(cfg_name)
    whole = llama.init(cfg, seed=3, device="cpu", quantize_int8=int8)
    return (bridge.params_to_numpy(llama.init(cfg, seed=3, device="cpu", quantize_int8=int8,
                                              mesh=mesh)),
            bridge.params_to_numpy(model_runner.shard_params(whole, cfg, mesh)))


def loaded_shards(mesh, src, int8):
    """load_llama_params with the mesh, and shard_params of the whole load."""
    kw = dict(device="cpu", dtype=torch.float32, quantize_int8=int8)
    cfg = checkpoint.config_from_hf(src)
    return (bridge.params_to_numpy(checkpoint.load_llama_params(src, cfg, mesh=mesh, **kw)),
            bridge.params_to_numpy(model_runner.shard_params(
                checkpoint.load_llama_params(src, cfg, **kw), cfg, mesh)))


def slot_logits(mesh, np_params, cfg_name, prompts, bucket, max_len, feed):
    """Each prompt prefilled into its slot, then one decode step per row of
    `feed` (the tokens of every slot, teacher-forced) -> (prefill logits
    [slots, V], decode logits [steps, slots, V])."""
    cfg, params = _params(np_params, cfg_name)
    params = model_runner.shard_params(params, cfg, mesh)
    state = model_runner.init_state(cfg, len(prompts), max_len, device="cpu", mesh=mesh)
    first = []
    for slot, prompt in enumerate(prompts):
        tokens = torch.zeros((1, bucket), dtype=torch.int64)
        tokens[0, :len(prompt)] = torch.tensor(prompt)
        state, last = model_runner.prefill(params, state, tokens, len(prompt), slot, cfg,
                                           mesh=mesh)
        first.append(last.numpy())
    active = torch.ones((len(prompts),), dtype=torch.bool)
    steps = []
    for row in feed:
        state, logits = model_runner.decode_step(params, state, torch.tensor(row), active,
                                                 cfg, mesh=mesh)
        steps.append(logits.numpy())
    return np.stack(first), np.stack(steps)


def paged_logits(mesh, np_params, cfg_name, prompts, bucket, max_len, num_blocks, bs,
                 install_at, feed):
    """As slot_logits in the paged layout: each prompt's detached prefill
    installed into one block (install_at[slot]), then decode steps."""
    cfg, params = _params(np_params, cfg_name)
    params = model_runner.shard_params(params, cfg, mesh)
    state = paged.init_paged_state(cfg, len(prompts), max_len, num_blocks, bs, device="cpu",
                                   mesh=mesh)
    first = []
    for slot, prompt in enumerate(prompts):
        tokens = torch.zeros((1, bucket), dtype=torch.int64)
        tokens[0, :len(prompt)] = torch.tensor(prompt)
        k, v, last = model_runner.prefill_detached(params, tokens, len(prompt), cfg, mesh=mesh)
        state = paged.install_prefill(state, k, v, [install_at[slot]], len(prompt), slot, 1)
        first.append(last.numpy())
    active = torch.ones((len(prompts),), dtype=torch.bool)
    steps = []
    for row in feed:
        state, logits = paged.decode_step_paged(params, state, torch.tensor(row), active, cfg,
                                                mesh=mesh)
        steps.append(logits.numpy())
    return np.stack(first), np.stack(steps)


def embed_rows(mesh, table, ids):
    """The vocab-parallel lookup of `ids` in this rank's rows of `table`."""
    local = shard_leaf(torch.from_numpy(table), ("vocab", "embed"), mesh, INFER_RULES)
    return llama._embed_lookup(local, torch.from_numpy(ids), torch.float32, mesh).numpy()


def world(mesh):
    """(rank, tp size, the group's backend) as this rank sees them."""
    return dist.get_rank(), mesh.size(mesh.mesh_dim_names.index("tp")), dist.get_backend()


# -- jobs of the training-mesh tests (tests/test_torch_port_train_mesh.py) --------------

_MESHES = {}


def mesh_of(spec):
    """A mesh of `spec` over the pool's ranks (built once per spec: every
    rank runs the same job, so the groups it makes line up)."""
    if spec not in _MESHES:
        _MESHES[spec] = build_mesh(spec, ["cpu"] * dist.get_world_size())
    return _MESHES[spec]


def coordinate(mesh):
    """This rank's index along every mesh axis (AXIS_ORDER)."""
    return tuple(mesh.get_coordinate())


def _leaves_requiring_grad(params):
    for p in llama.tree_leaves(params):
        p.requires_grad_(True)
    return params


def train_steps(_, spec, np_params, cfg_kw, batch, opt_kw, n_steps):
    """make_train_step(mesh=) on the rank's TRAIN_RULES shards of the
    bridged params, n_steps on the global `batch` -> (coordinate, metrics of
    each step as f32 host floats, the shards after each step, AdamW's state
    after the last, the loss_mask tokens of the rank's own rows)."""
    mesh = mesh_of(spec)
    cfg = get_config(**cfg_kw)
    tx = train_step.make_optimizer(**opt_kw)
    params = _leaves_requiring_grad(bridge.params_from_jax(np_params, cfg, device="cpu",
                                                           mesh=mesh, rules=TRAIN_RULES))
    state = train_step.TrainState(0, params, tx.init(llama.tree_leaves(params)))
    step = train_step.make_train_step(cfg, tx, device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    metrics, shards = [], []
    for _ in range(n_steps):
        state, m = step(state, batch)
        metrics.append({k: v.item() for k, v in m.items()})
        shards.append(copy.deepcopy(bridge.params_to_numpy(state.params)))  # views: the
        # next step updates the tensors in place
    own = shard_view(batch["loss_mask"][:, 1:], ("batch", None), mesh, TRAIN_RULES)
    return dict(coord=coordinate(mesh), metrics=metrics, params=shards,
                opt=bridge.opt_state_to_numpy(state.opt_state, state.params),
                own_tokens=int(own.sum()))


def init_shards(_, spec, cfg_name, src):
    """init_state(mesh=) from the seed and from the checkpoint at `src`, with
    the shards of the whole init and of the whole load by TRAIN_RULES ->
    {name: (got params, want params)}, and the moments' shapes against the
    shards'."""
    mesh = mesh_of(spec)
    cfg = get_config(cfg_name)
    tx = train_step.make_optimizer()
    axes = llama.param_axes(cfg)

    def shard(p):
        return bridge.params_to_numpy(shard_pytree(p, axes, mesh, TRAIN_RULES))

    seeded = train_step.init_state(cfg, tx, seed=4, device="cpu", mesh=mesh)
    loaded = train_step.init_state(cfg, tx, device="cpu", mesh=mesh, checkpoint_dir=src)
    whole_load = checkpoint.load_llama_params(src, cfg, device="cpu", dtype=torch.float32)
    out = {
        "init": (bridge.params_to_numpy(llama.init(cfg, seed=4, device="cpu", mesh=mesh,
                                                   rules=TRAIN_RULES)),
                 shard(llama.init(cfg, seed=4, device="cpu"))),
        "init_state": (bridge.params_to_numpy(seeded.params),
                       shard(llama.init(cfg, seed=4, device="cpu"))),
        "load": (bridge.params_to_numpy(checkpoint.load_llama_params(
            src, cfg, device="cpu", dtype=torch.float32, mesh=mesh, rules=TRAIN_RULES)),
                 shard(whole_load)),
        "init_state_checkpoint": (bridge.params_to_numpy(loaded.params), shard(whole_load)),
    }
    moments = [(tuple(m.shape), tuple(n.shape), tuple(p.shape), float(m.abs().sum()),
                float(n.abs().sum()))
               for m, n, p in zip(seeded.opt_state.mu, seeded.opt_state.nu,
                                  llama.tree_leaves(seeded.params))]
    return out, moments


def refusal(_, what):
    """The NotImplementedError a training mesh raises for `what` (moe, sync,
    sp, pp), or None when nothing raises."""
    spec = {"sp": MeshSpec(sp=2, tp=2), "pp": MeshSpec(pp=2, dp=2)}.get(what,
                                                                        MeshSpec(fsdp=2, tp=2))
    mesh = mesh_of(spec)
    cfg = get_config("moe-tiny" if what == "moe" else "test-tiny")
    tx = train_step.make_optimizer()
    sync = object() if what == "sync" else None
    got = []
    for call in (lambda: train_step.init_state(cfg, tx, device="cpu", mesh=mesh, sync=sync),
                 lambda: train_step.make_train_step(cfg, tx, device="cpu", mesh=mesh,
                                                    sync=sync)):
        try:
            call()
            got.append(None)
        except NotImplementedError as e:
            got.append(str(e))
    return got


def collective_grads(_, spec, axis, name, x):
    """One differentiable collective over `axis` on rank-distinct inputs
    (x + the rank's index along the axis), then a loss that weighs each
    output element by (rank's index along the axis + 1) -> (coordinate,
    the output, the input's gradient)."""
    mesh = mesh_of(spec)
    i = mesh.get_local_rank(axis)
    inp = (torch.from_numpy(x) + i).requires_grad_(True)
    fn = {"all_reduce": lambda t: sharding.all_reduce(t, mesh, axis),
          "copy_to": lambda t: sharding.copy_to(t, mesh, axis),
          "all_gather": lambda t: sharding.all_gather(t, mesh, axis, dim=1),
          "gather_shard": lambda t: sharding.gather_shard(t, mesh, axis, dim=1)}[name]
    out = fn(inp)
    (grad,) = torch.autograd.grad((out * (i + 1)).sum(), inp)
    return coordinate(mesh), out.detach().numpy(), grad.numpy()


def global_norm_of(_, spec, leaves, leaf_axes):
    """optim.global_norm over this rank's TRAIN_RULES shards of `leaves`."""
    mesh = mesh_of(spec)
    shards = [shard_leaf(torch.from_numpy(x), ax, mesh, TRAIN_RULES)
              for x, ax in zip(leaves, leaf_axes)]
    cuts = [sharding.cut_axes(ax, mesh, TRAIN_RULES) for ax in leaf_axes]
    return optim.global_norm(shards, mesh, cuts).item()


# -- jobs of the data-parallel tests (tests/test_torch_port_data_parallel.py) ------------

def _pool(state):
    """This rank's pool partition without its scratch block, its tables and
    lengths (numpy copies)."""
    return dict(k=state.k[:, :-1].numpy().copy(), v=state.v[:, :-1].numpy().copy(),
                tables=state.block_tables.numpy().copy(), lengths=state.lengths.numpy().copy())


def _tokens(prompt, bucket):
    tokens = torch.zeros((1, bucket), dtype=torch.int64)
    tokens[0, :len(prompt)] = torch.tensor(prompt)
    return tokens


def _owns(mesh, slot, per):
    """Whether this rank's replica owns `slot`: the single-slot _dp
    functions run there only, as the engine's ShardRunner makes them."""
    return model_runner.slot_replica(slot, per)[0] == axis_index(mesh, "dp")


def _installed(params, cfg, mesh, plan, prompts):
    """A fresh pool of plan's geometry, each prompt's detached prefill
    installed by install_prefill_dp into plan["ids"][slot] (replica-local)
    on the owning replica -> (state, the prefill logits [S, V])."""
    s_n = len(prompts)
    per = s_n // mesh.size(mesh.mesh_dim_names.index("dp"))
    state = paged.init_paged_state(cfg, s_n, plan["max_len"], plan["num_blocks"], plan["bs"],
                                   device="cpu", mesh=mesh)
    first = []
    for slot, (prompt, ids) in enumerate(zip(prompts, plan["ids"])):
        k, v, last = model_runner.prefill_detached(params, _tokens(prompt, plan["bucket"]),
                                                   len(prompt), cfg, mesh=mesh)
        if _owns(mesh, slot, per):
            paged.install_prefill_dp(state, k, v, ids, len(prompt), slot, len(ids), mesh, per)
        first.append(last.numpy())
    return state, np.stack(first), per


def dp_functions(_, spec, np_params, cfg_name, plan):
    """The paged _dp functions on this rank, in plan's order (the JAX side
    runs the same calls): installs, appends, decode steps fed plan["feed"],
    a greedy fused burst; on a second pool spec_multi and verify (when
    plan["with_spec"]); then the prefix cache's warm path and
    install_with_prefix_dp -> each step's outputs and this rank's pool
    partition after it."""
    mesh = mesh_of(spec)
    cfg, params = _params(np_params, cfg_name)
    params = model_runner.shard_params(params, cfg, mesh)
    out = {"coord": coordinate(mesh)}
    state, out["first"], per = _installed(params, cfg, mesh, plan, plan["prompts"])
    out["installed"] = _pool(state)
    for slot, (index, bid) in enumerate(plan["appends"]):
        if _owns(mesh, slot, per):
            paged.append_block_dp(state, slot, index, bid, mesh, per)
    out["appended"] = _pool(state)
    s_n = len(plan["prompts"])
    active = torch.ones((s_n,), dtype=torch.bool)
    greedy = (torch.zeros((s_n,)), torch.ones((s_n,)), torch.zeros((s_n,), dtype=torch.int64))
    steps = []
    for row in plan["feed"]:
        state, logits = paged.decode_step_paged_dp(params, state, torch.tensor(row), active,
                                                   cfg, mesh)
        steps.append(logits.numpy())
    out["steps"], out["decoded"] = np.stack(steps), _pool(state)
    n = plan["burst"]
    state, toks = paged.decode_multi_paged_dp(
        params, state, torch.tensor(plan["burst_from"]), torch.tensor(plan["burst_active"]),
        cfg, n, *greedy, torch.full((s_n,), n), None, mesh)
    out["burst"], out["bursted"] = toks.numpy(), _pool(state)

    state, _, _ = _installed(params, cfg, mesh, plan, plan["spec_prompts"])
    for slot, (index, bid) in enumerate(plan["appends"]):
        if _owns(mesh, slot, per):
            paged.append_block_dp(state, slot, index, bid, mesh, per)
    if plan["with_spec"]:
        hist = torch.zeros((s_n, plan["max_len"]), dtype=torch.int64)
        for slot, q in enumerate(plan["spec_prompts"]):
            hist[slot, :len(q)] = torch.tensor(q)
        hlen = torch.tensor([len(q) for q in plan["spec_prompts"]])
        m, k, nmax = plan["spec"]
        state, *multi = paged.spec_multi_paged_dp(params, state, hist, hlen, active, cfg,
                                                  *greedy, m, k, nmax, None, mesh)
        out["multi"], out["multied"] = [t.numpy() for t in multi], _pool(state)
        window, draft_len = torch.tensor(plan["window"]), torch.tensor(plan["draft_len"])
        state, toks, n_acc = paged.spec_verify_step_paged_dp(params, state, window, draft_len,
                                                             active, cfg, *greedy, None, mesh)
        out["verify"], out["verified"] = (toks.numpy(), n_acc.numpy()), _pool(state)

    suffix, slot = plan["suffix"], plan["warm_slot"]
    out["warm"] = None
    if _owns(mesh, slot, per):
        warm = paged.prefill_suffix_from_state_dp(params, state, plan["cached"],
                                                  _tokens(suffix, plan["bs"]), len(suffix),
                                                  cfg, len(plan["cached"]), mesh, per, slot)
        out["warm"] = [t.numpy() for t in warm]
        paged.install_with_prefix_dp(state, warm[0], warm[1], plan["new_ids"], plan["row"],
                                     plan["warm_len"], slot, len(plan["new_ids"]), mesh, per)
    out["warmed"] = _pool(state)
    return out


def runner_draws(_, spec, np_params, cfg_name, config_kw, prompt, n_steps, temperature):
    """An engine's ShardRunner on this rank: `prompt` prefilled into every
    slot, then a fused burst of n_steps for all slots, sampled at
    `temperature` -> (coordinate, the first tokens (rank 0's are the
    engine's), the burst's tokens [n_steps, S] as this rank holds them)."""
    from ray_tpu_torch.llm.config import LLMConfig
    from ray_tpu_torch.llm.tp_worker import ShardRunner

    mesh = mesh_of(spec)
    cfg, params = _params(np_params, cfg_name)
    config = LLMConfig(model_source=cfg_name, dtype="float32", **config_kw)
    runner = ShardRunner(config, torch.device("cpu"), mesh, params)
    runner.init_state()
    s_n = config.max_num_seqs
    sampling = (temperature, 1.0, 0)
    if config.kv_layout == "paged":
        per_slot = config.max_model_len // config.kv_block_size
        first = [runner.prefill_paged(prompt, s, list(range(s % runner.slots_per * per_slot,
                                                            (s % runner.slots_per + 1) * per_slot)),
                                      sampling) for s in range(s_n)]
    else:
        first = [runner.prefill(prompt, s, sampling) for s in range(s_n)]
    first = [None if t is None else int(t[0]) for t in first]
    toks = runner.decode(np.array([t or 0 for t in first], np.int64), np.ones((s_n,), bool),
                         n_steps, np.full((s_n,), temperature, np.float32),
                         np.ones((s_n,), np.float32), np.zeros((s_n,), np.int64),
                         np.full((s_n,), n_steps, np.int64))
    return coordinate(mesh), first, toks.numpy()


def runner_ids(_, spec, np_params, model_cfg, config_kw, prompts, slots, n_gen):
    """An engine's ShardRunner for `model_cfg` (a ModelConfig) on this rank:
    prompts[i] prefilled into slots[i] (paged: into the block of its local
    slot's index), then one greedy burst of n_gen - 1 steps for every slot
    -> each prompt's n_gen ids as this rank holds them."""
    from ray_tpu_torch.llm.config import LLMConfig
    from ray_tpu_torch.llm.tp_worker import ShardRunner

    mesh = mesh_of(spec)
    params = bridge.params_from_jax(np_params, model_cfg, device="cpu")
    config = LLMConfig(model_source=model_cfg, dtype="float32", **config_kw)
    runner = ShardRunner(config, torch.device("cpu"), mesh, params)
    runner.init_state()
    s_n, greedy = config.max_num_seqs, (0.0, 1.0, 0)
    first = np.zeros((s_n,), np.int64)
    for prompt, slot in zip(prompts, slots):
        if config.kv_layout == "paged":
            local = model_runner.slot_replica(slot, runner.slots_per)[1]
            tok = runner.prefill_paged(prompt, slot, [local], greedy)
        else:
            tok = runner.prefill(prompt, slot, greedy)
        first[slot] = int(tok[0])
    toks = runner.decode(first, np.ones((s_n,), bool), n_gen - 1, np.zeros((s_n,), np.float32),
                         np.ones((s_n,), np.float32), np.zeros((s_n,), np.int64),
                         np.full((s_n,), n_gen - 1, np.int64)).numpy()
    return [[int(first[s])] + [int(t) for t in toks[:, s]] for s in slots]


# -- jobs of the pipeline-parallel tests (tests/test_torch_port_pipeline_parallel.py) ----

def _cache(state):
    """This rank's KV state as numpy copies: every layer of its stage, every
    slot (or pool block, its scratch block dropped) of its replica."""
    pool = isinstance(state, paged.PagedState)
    out = dict(k=(state.k[:, :-1] if pool else state.k).numpy().copy(),
               v=(state.v[:, :-1] if pool else state.v).numpy().copy(),
               lengths=state.lengths.numpy().copy())
    if pool:
        out["tables"] = state.block_tables.numpy().copy()
    return out


def pp_functions(_, spec, np_params, cfg_name, plan):
    """The port's pipelined functions on this rank, in plan's order (the JAX
    side runs the same calls): each prompt prefilled into its slot on the
    replica that owns it (every stage of it: model_runner.prefill, or
    prefill_detached and PagedOps.install_prefill into plan["ids"], then
    the appended blocks), decode_step_pp (or decode_step_paged_pp) fed
    plan["feed"] with plan["active"], then one greedy speculative verify
    window -> each step's outputs and this rank's KV after it."""
    mesh = mesh_of(spec)
    cfg, params = _params(np_params, cfg_name)
    params = model_runner.shard_params(params, cfg, mesh)
    s_n, layout = len(plan["prompts"]), plan["layout"]
    per = s_n // mesh.size(mesh.mesh_dim_names.index("dp"))
    ops = paged.PagedOps(cfg, mesh, s_n)
    if layout == "paged":
        state = paged.init_paged_state(cfg, s_n, plan["max_len"], plan["num_blocks"],
                                       plan["bs"], device="cpu", mesh=mesh)
    else:
        state = model_runner.init_state(cfg, s_n, plan["max_len"], device="cpu", mesh=mesh)
    first = [None] * s_n
    for slot, prompt in enumerate(plan["prompts"]):
        if not _owns(mesh, slot, per):
            continue
        tokens = _tokens(prompt, plan["bucket"])
        if layout == "paged":
            k, v, last = model_runner.prefill_detached(params, tokens, len(prompt), cfg,
                                                       mesh=mesh)
            ids = plan["ids"][slot]
            state = ops.install_prefill(state, k, v, ids, len(prompt), slot, len(ids))
            index, bid = plan["appends"][slot]
            state = ops.append_block(state, slot, index, bid)
        else:
            state, last = model_runner.prefill(params, state, tokens, len(prompt), slot % per,
                                               cfg, mesh=mesh)
        first[slot] = last.numpy()
    out = {"coord": coordinate(mesh), "first": first, "installed": _cache(state)}
    active = torch.tensor(plan["active"])
    step = paged.decode_step_paged_pp if layout == "paged" else model_runner.decode_step_pp
    verify = (paged.spec_verify_step_paged_pp if layout == "paged"
              else model_runner.spec_verify_step_pp)
    steps = []
    for row in plan["feed"]:
        state, logits = step(params, state, torch.tensor(row), active, cfg, mesh)
        steps.append(logits.numpy())
    out["steps"], out["decoded"] = np.stack(steps), _cache(state)
    greedy = (torch.zeros((s_n,)), torch.ones((s_n,)), torch.zeros((s_n,), dtype=torch.int64))
    state, toks, n_acc = verify(params, state, torch.tensor(plan["window"]),
                                torch.tensor(plan["draft_len"]), active, cfg, *greedy, None,
                                mesh)
    out["verify"], out["verified"] = (toks.numpy(), n_acc.numpy()), _cache(state)
    return out


def _leaf_shapes(params):
    return {name: ({k: tuple((v.q if hasattr(v, "q") else v).shape) for k, v in val.items()}
                   if isinstance(val, dict) else tuple(val.shape))
            for name, val in params.items()}


def stage_leaves(_, spec, np_params, cfg_name, src):
    """What a pipeline stage holds at `spec`: the leaf shapes and values of
    the engine's weights from each source (llm/tp_worker.load_params: the
    seeded init, a checkpoint directory `src`, a whole parameter dict,
    int8), each beside this rank's shard of the whole one by
    infer_rules_for_mesh; the bridge's shard of the JAX tree; and the shapes
    of its slot cache, paged pool and a prefill's cache."""
    from ray_tpu_torch.llm.config import LLMConfig
    from ray_tpu_torch.llm.tp_worker import load_params, param_bytes

    mesh = mesh_of(spec)
    cfg = get_config(cfg_name)
    rules = model_runner.infer_rules_for_mesh(mesh)
    axes = llama.param_axes(cfg)
    dev = torch.device("cpu")

    def config(**kw):
        return LLMConfig(model_source=kw.pop("model_source", cfg_name), dtype="float32", **kw)

    def shard(p):
        return bridge.params_to_numpy(shard_pytree(p, axes, mesh, rules))

    whole_np = bridge.params_from_jax(np_params, cfg, device="cpu")
    got = {
        "init": (load_params(config(), dev, mesh), llama.init(cfg, seed=0, device="cpu")),
        "int8": (load_params(config(quantization="int8"), dev, mesh),
                 quantize_llama_params(llama.init(cfg, seed=0, device="cpu"))),
        "checkpoint": (load_params(config(model_source=src), dev, mesh),
                       checkpoint.load_llama_params(src, cfg, device="cpu",
                                                    dtype=torch.float32)),
        "params": (load_params(config(), dev, mesh, whole_np), whole_np),
    }
    out = {"coord": coordinate(mesh)}
    for name, (mine, whole) in got.items():
        out[name] = dict(shapes=_leaf_shapes(mine), bytes=param_bytes(mine),
                         whole_bytes=param_bytes(whole), got=bridge.params_to_numpy(mine),
                         want=shard(whole))
    out["bridge"] = (bridge.params_to_numpy(bridge.params_from_jax(np_params, cfg, device="cpu",
                                                                  mesh=mesh, rules=rules)),
                     shard(whole_np))
    out["caches"] = dict(
        slot=tuple(model_runner.init_state(cfg, 4, 64, device="cpu", mesh=mesh).k.shape),
        paged=tuple(paged.init_paged_state(cfg, 4, 64, 8, 16, device="cpu", mesh=mesh).k.shape),
        prefill=tuple(llama.init_kv_cache(cfg, 1, 32, device="cpu", mesh=mesh).k.shape))
    return out


def stage_hops(_, spec, x):
    """parallel.pipeline on this rank: stage s sends x + s on and receives
    the previous stage's, then every stage takes the last stage's
    (x + last) -> (coordinate, what it received or None, the broadcast)."""
    from ray_tpu_torch.parallel import pipeline

    mesh = mesh_of(spec)
    stage = axis_index(mesh, "pp")
    last = mesh.size(mesh.mesh_dim_names.index("pp")) - 1
    mine = torch.from_numpy(x) + stage
    got = None
    if stage > 0:
        got = pipeline.recv_from_prev(x.shape, mine.dtype, "cpu", mesh).numpy()
    if stage < last:
        pipeline.send_to_next(mine, mesh)
    return coordinate(mesh), got, pipeline.from_last_stage(mine, mesh).numpy()
