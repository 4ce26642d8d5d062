"""Port ranks for the tensor-parallel parity tests: N spawned CPU processes
joined in a gloo mesh of tp = N, each running the jobs the test process
sends it and sending back what it got. The jobs import the port only (no
JAX): a rank is a fresh interpreter, and JAX stays in the test process.

Every wait is bounded: a job that does not answer within the timeout, or a
rank that dies, fails the test that sent it; ``close`` joins each rank with
a timeout and kills what is left.
"""
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
from ray_tpu_torch.parallel import INFER_RULES, MeshSpec, build_mesh, shard_leaf

TIMEOUT_S = 60.0  # the groups' own bound (parallel.mesh.GROUP_TIMEOUT_S)


def _rank_main(rank, n, init_method, inbox, outbox):
    torch.set_num_threads(1)
    try:
        mesh = build_mesh(MeshSpec(tp=n), ["cpu"] * n, rank=rank, init_method=init_method)
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
    """N port ranks (spawned once); ``run(fn, *args)`` -> each rank's result."""

    def __init__(self, n=2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, n, f"tcp://127.0.0.1:{port}", self.inboxes[r],
                                        self.outbox))
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
