"""The device half of a TorchLLMEngine, and the followers of a multi-rank one.

``ShardRunner`` holds what an engine keeps on its device: the weights (this
rank's shard under tensor parallelism), the KV state, the sampling
generator, and one method per model-runner or paged call the engine makes,
each taking host values (token lists, numpy arrays, ints) and returning
device tensors. The engine's scheduler, block manager and request
bookkeeping stay on the host of rank 0.

With ``pipeline_parallel_size`` = P, ``data_parallel_size`` = D and
``tensor_parallel_size`` = T, P × D × T > 1, the engine is rank 0 of a mesh of
P × D × T ranks, MeshSpec(pp=P, dp=D, tp=T), stage 0 of replica 0
(``Followers``): it spawns the other ranks, each running ``follower_main``,
and announces every call over the whole world (the op's name and its small
host arguments, ``broadcast_object_list``) before making it itself; each
follower makes the same call on its own ShardRunner. The collectives inside
the model run over this rank's tp subgroup (``mesh.get_group("tp")``), so
they meet among the T ranks of one replica. Every rank of a replica holds
the same all-gathered logits and a generator seeded and advanced alike, so
sampling inside a fused burst stays in step; rank 0's host-side tokens ride
in the next call's arguments.

Data parallelism: each replica holds the whole model (its tp shards) and
max_num_seqs / D slots (``model_runner.slot_replica`` says which replica owns
a slot). A call for one slot (``prefill``, ``prefill_paged``,
``prefill_prefix``, ``install_transfer``, ``append_block``) runs on the owning
replica only, which ``ShardRunner._local`` decides here and nowhere else, and
a prefill's first token reaches rank 0 by one small broadcast over "dp" from
the owner's tp-rank 0. A P/D transfer's KV is not announced: rank 0 sends it
to the owning rank alone. Where the JAX package runs a slot's prefill on every
replica and masks the install, and psums the owner's cached blocks for the
prefix cache's warm path, owner-only compute gives the owner the same result
with no collective. A batched call (``decode``, ``spec_verify``,
``spec_multi``) runs the dp 1 function on the replica's slots, whose per-slot
results are all-gathered over "dp" (model_runner.over_replicas); a replica
with no active slot skips the model and still joins the gather. Each replica
seeds its generator with its dp index.

Pipeline parallelism: each stage holds n_layers / P layers (and their KV) of
its replica. Every call runs on every stage of a replica: a prefill stage by
stage, a batched call through the microbatch schedule
(model_runner._pp_schedule), after which every stage holds the same logits
and samples alike. So "the owning replica" of a call for one slot means all
its stages, and the first token reaches rank 0 as at pp 1, over "dp" from
the owner's stage-0 tp-rank 0 (every stage of it holds the token).

A follower that raises prints its traceback and exits at once, which fails
rank 0's next collective ("connection closed") instead of leaving it to
wait. An idle engine pings the followers (``ping``) well inside the group
timeout, since a follower waiting for the next call is inside a collective
too.

This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import multiprocessing
import os
import socket
import sys
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import checkpoint, llama
from ray_tpu_torch.models.config import torch_dtype
from ray_tpu_torch.ops import flash_attention
from ray_tpu_torch.ops.quant import QTensor, quantize_llama_params
from ray_tpu_torch.parallel.mesh import GROUP_TIMEOUT_S, MeshSpec, axis_index, axis_size, build_mesh

from . import model_runner, paged
from .config import LLMConfig

# seconds an idle rank 0 lets pass between two calls before it pings its
# followers: well inside the group timeout a waiting follower is held to
PING_S = GROUP_TIMEOUT_S / 4
# seconds shutdown() waits for each follower to exit before it kills it
JOIN_S = 10.0
# what a rank counts (ShardRunner.rank_counts): the prefills it computed
# whole or chunked, those over a cached prefix, and the decode steps (or
# verify windows) in which its replica had an active slot
COUNTS = ("prefills", "prefix_prefills", "active_steps")


def load_params(config: LLMConfig, device, mesh=None, params=None):
    """The engine's weights on `device` in config.dtype (this rank's shard
    with a mesh), int8 when config.quantization says so: `params` (a whole
    parameter dict) placed, quantized whole on the device and then sharded;
    else a checkpoint directory's load or the seeded init, which quantize
    and shard piece by piece."""
    cfg = config.resolve_model_config()
    dtype = torch_dtype(config.dtype)
    int8 = bool(config.quantization)
    rules = model_runner.infer_rules_for_mesh(mesh)  # a stage holds its layers
    if params is not None:
        def place(v):
            if isinstance(v, QTensor):
                return QTensor(v.q.to(device), v.s.to(device))
            return v.to(device, dtype)

        placed = {name: ({k: place(v) for k, v in val.items()}
                         if name == "layers" else place(val))
                  for name, val in params.items()}
        if int8:
            # on the device, one layer at a time (ray_tpu/llm/engine.py:325-331)
            placed = quantize_llama_params(placed)
        return model_runner.shard_params(placed, cfg, mesh)
    if checkpoint.looks_like_checkpoint_dir(config.model_source):
        # real weights, streamed piece by piece into preallocated leaves
        return checkpoint.load_llama_params(
            config.model_source, cfg, device=device, dtype=dtype, quantize_int8=int8,
            mesh=mesh, rules=rules)
    # int8: each layer quantized as it is drawn, never the whole float model
    return llama.init(cfg, seed=0, device=device, dtype=dtype, quantize_int8=int8,
                      mesh=mesh, rules=rules)


def param_bytes(params) -> int:
    """Bytes of a parameter dict's tensors (an int8 leaf's values and scales)."""
    total = 0
    for val in params.values():
        for leaf in (val.values() if isinstance(val, dict) else [val]):
            parts = (leaf.q, leaf.s) if isinstance(leaf, QTensor) else (leaf,)
            total += sum(t.numel() * t.element_size() for t in parts)
    return total


def _pad_blocks(k: torch.Tensor, v: torch.Tensor, n_blocks: int, bs: int):
    """Zero-pad prefill KV [L, 1, S, ...] along S to n_blocks * bs rows."""
    extra = n_blocks * bs - k.shape[2]
    if extra <= 0:
        return k, v
    pad = (0, 0, 0, 0, 0, extra)
    return torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)


class ShardRunner:
    """An engine's device state on one rank and the calls that change it.
    `mesh` is None on one device; `params` a whole parameter dict or None
    (see load_params). Under data parallelism the rank serves its replica's
    slots: a call for one slot runs on the owning replica only, at its local
    slot, and a batched call on the replica's rows (``ops``). Under pipeline
    parallelism the rank is stage `stage` of its replica."""

    def __init__(self, config: LLMConfig, device, mesh=None, params=None):
        self.config = config
        self.cfg = config.resolve_model_config()
        self.device = device
        self.mesh = mesh
        self.params = load_params(config, device, mesh, params)
        self.state = None  # model_runner.DecodeState | paged.PagedState
        self.ops = None  # model_runner.SlotOps | paged.PagedOps
        self.dp = axis_size(mesh, "dp")
        self.replica = axis_index(mesh, "dp")
        self.tp_index = axis_index(mesh, "tp")
        self.stage = axis_index(mesh, "pp")
        self.slots_per = config.max_num_seqs // self.dp
        # one sampling stream per replica (JAX folds the dp index into its
        # keys); the tp ranks of a replica seed and advance theirs alike
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(self.replica)
        self.counts = dict.fromkeys(COUNTS, 0)

    # -- helpers ------------------------------------------------------------------
    def _t(self, a, dtype=None) -> torch.Tensor:
        """A host array (or list) as a tensor on this rank's device."""
        t = torch.from_numpy(a) if isinstance(a, np.ndarray) else torch.as_tensor(a)
        return t.to(self.device) if dtype is None else t.to(self.device, dtype)

    def _local(self, slot: int) -> Optional[int]:
        """The local slot when this rank's replica owns `slot`, else None:
        the one gate of the calls for one slot (under pp it admits every
        stage of the owning replica, which all take part)."""
        replica, local = model_runner.slot_replica(slot, self.slots_per)
        return local if replica == self.replica else None

    def _from_owner(self, slot: int, tok: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A slot's first token [1] on rank 0: under dp > 1 one broadcast over
        "dp" from the owning replica's tp-rank 0 (the tp ranks of a replica
        sample alike, so only tp-rank 0 of each replica joins)."""
        if self.dp == 1 or self.tp_index != 0:
            return tok
        if tok is None:
            tok = torch.zeros((1,), dtype=torch.int64, device=self.device)
        group = self.mesh.get_group("dp")
        owner = model_runner.slot_replica(slot, self.slots_per)[0]
        dist.broadcast(tok, src=dist.get_global_rank(group, owner), group=group)
        return tok

    def _count_active(self, active, steps: int) -> None:
        """Count `steps` decode steps (or verify windows) when this replica
        has an active slot in them."""
        if np.asarray(active)[model_runner.replica_slots(self.replica, self.slots_per)].any():
            self.counts["active_steps"] += steps

    def pad_to_bucket(self, prompt_ids: List[int]) -> torch.Tensor:
        s_pad = next(b for b in self.config.buckets() if b >= len(prompt_ids))
        tokens = np.zeros((1, s_pad), np.int64)
        tokens[0, : len(prompt_ids)] = prompt_ids
        return self._t(tokens)

    def prefill_kv(self, prompt: List[int]):
        """(k, v, last_logits) of a prompt: chunked when it is longer than
        prefill_chunk, else one detached prefill padded to a bucket."""
        c = self.config
        if c.prefill_chunk and len(prompt) > c.prefill_chunk:
            return paged.chunked_prefill(self.params, prompt, self.cfg, c.prefill_chunk,
                                         self.device, mesh=self.mesh)
        return model_runner.prefill_detached(self.params, self.pad_to_bucket(prompt),
                                             len(prompt), self.cfg, mesh=self.mesh)

    def sample_one(self, logits: torch.Tensor, temperature: float, top_p: float,
                   top_k: int) -> torch.Tensor:
        """One token [1] sampled from last-position logits [vocab]."""
        return model_runner.sample_tokens(
            logits[None, :], self._t([temperature], torch.float32),
            self._t([top_p], torch.float32), self._t([top_k], torch.int64), self.gen)

    def _sampling(self, temp, top_p, top_k):
        return self._t(temp), self._t(top_p), self._t(top_k)

    # -- calls the engine makes (each announced to the followers) -------------------
    def ping(self) -> None:
        """Nothing: keeps a waiting follower inside its group timeout."""

    def init_state(self) -> None:
        """The decode KV state: the paged pool or the slot cache (this
        replica's partition or slots under dp)."""
        c = self.config
        if c.kv_layout == "paged":
            self.ops = paged.PagedOps(self.cfg, self.mesh, c.max_num_seqs)
            self.state = paged.init_paged_state(
                self.cfg, c.max_num_seqs, c.max_model_len, c.kv_pool_blocks(),
                c.kv_block_size, self.device, mesh=self.mesh)
        else:
            self.ops = model_runner.SlotOps(self.cfg, self.mesh)
            self.state = model_runner.init_state(self.cfg, c.max_num_seqs, c.max_model_len,
                                                 self.device, mesh=self.mesh)

    def prefill(self, prompt: List[int], slot: int, sampling) -> Optional[torch.Tensor]:
        """Slot layout: the prompt into `slot`, whole or chunk by chunk (then
        installed at once) -> its first token [1]."""
        c = self.config
        local, tok = self._local(slot), None
        if local is not None:
            if c.prefill_chunk and len(prompt) > c.prefill_chunk:
                # bounded activation memory; the assembled KV is installed at once
                k, v, last = self.prefill_kv(prompt)
                self.state = model_runner.install_kv(self.state, k, v, len(prompt), local)
            else:
                self.state, last = model_runner.prefill(
                    self.params, self.state, self.pad_to_bucket(prompt), len(prompt), local,
                    self.cfg, mesh=self.mesh)
            self.counts["prefills"] += 1
            tok = self.sample_one(last, *sampling)
        return self._from_owner(slot, tok)

    def _install_paged(self, slot: int, k, v, n: int, block_ids: List[int]) -> None:
        k, v = _pad_blocks(k, v, len(block_ids), self.config.kv_block_size)
        self.state = self.ops.install_prefill(self.state, k, v, block_ids, n, slot,
                                              len(block_ids))

    def prefill_paged(self, prompt: List[int], slot: int, block_ids: List[int],
                      sampling) -> Optional[torch.Tensor]:
        """Paged layout: the prompt into its allocated blocks -> its first token."""
        tok = None
        if self._local(slot) is not None:
            k, v, last = self.prefill_kv(prompt)
            self._install_paged(slot, k, v, len(prompt), block_ids)
            self.counts["prefills"] += 1
            tok = self.sample_one(last, *sampling)
        return self._from_owner(slot, tok)

    def prefill_prefix(self, suffix: List[int], n: int, slot: int, cached_ids: List[int],
                       new_ids: List[int], sampling) -> Optional[torch.Tensor]:
        """Paged layout with a prefix hit: the suffix over the cached blocks'
        KV into new blocks; the slot's table holds the cached ids, then the
        new -> the first token."""
        c = self.config
        tok = None
        if self._local(slot) is not None:
            k, v, last = self.ops.prefill_suffix_from_state(
                self.params, self.state, cached_ids, self.pad_to_bucket(suffix), len(suffix),
                len(cached_ids), slot)
            k, v = _pad_blocks(k, v, len(new_ids), c.kv_block_size)
            row = np.zeros((c.max_model_len // c.kv_block_size,), np.int64)
            row[:len(cached_ids) + len(new_ids)] = cached_ids + new_ids
            self.state = self.ops.install_with_prefix(self.state, k, v, new_ids, row, n, slot,
                                                      len(new_ids))
            self.counts["prefix_prefills"] += 1
            tok = self.sample_one(last, *sampling)
        return self._from_owner(slot, tok)

    def install_transfer(self, slot: int, k, v, n: int, block_ids: Optional[List[int]]):
        """A P/D transfer's KV (tensors or f32 numpy arrays) copied to the
        device and installed: into `block_ids` (paged) or `slot`, on the
        replica that owns the slot. Under dp > 1 (at tp 1: P/D under tp is
        refused) the followers are announced no KV (Followers.announce):
        rank 0 sends it to the owning rank alone."""
        local = self._local(slot)
        if self.dp > 1:
            owner = dist.get_global_rank(self.mesh.get_group("dp"),
                                         model_runner.slot_replica(slot, self.slots_per)[0])
            if dist.get_rank() == 0 and owner != 0:
                dist.send_object_list([x.cpu() if isinstance(x, torch.Tensor) else x
                                       for x in (k, v)], dst=owner)
            elif local is not None and owner != 0:
                box: List[Any] = [None, None]
                dist.recv_object_list(box, src=0)
                k, v = box
        if local is None:
            return
        k, v = ((x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x)))
                .to(self.device) for x in (k, v))
        if block_ids is not None:
            self._install_paged(slot, k, v, n, block_ids)
        else:
            self.state = model_runner.install_kv(self.state, k, v, n, local)

    def append_block(self, slot: int, index: int, block_id: int) -> None:
        if self._local(slot) is not None:
            self.state = self.ops.append_block(self.state, slot, index, block_id)

    def decode(self, last, active, k_steps: int, temp, top_p, top_k, steps) -> torch.Tensor:
        """One decode step, or a fused burst of k_steps, for every slot ->
        the sampled tokens [k_steps, slots]. Under dp > 1 a single step is a
        burst of one too, so that tokens, not logits, cross the replicas."""
        self._count_active(active, k_steps)
        last, active = self._t(last), self._t(active)
        temp, top_p, top_k = self._sampling(temp, top_p, top_k)
        if k_steps > 1 or self.dp > 1:
            self.state, toks = self.ops.decode_multi(
                self.params, self.state, last, active, k_steps, temp, top_p, top_k,
                self._t(steps), self.gen)
            return toks
        self.state, logits = self.ops.decode_step(self.params, self.state, last, active)
        return model_runner.sample_tokens(logits, temp, top_p, top_k, self.gen)[None, :]

    def decode_logits(self, last, active) -> torch.Tensor:
        """One decode step of every slot -> its logits [S, vocab], under dp
        > 1 every replica's rows gathered (SlotOps.decode_step,
        paged.decode_step_paged_dp): a teacher-forced check's step, where
        the engine's own steps sample on each replica (decode)."""
        self._count_active(active, 1)
        self.state, logits = self.ops.decode_step(self.params, self.state, self._t(last),
                                                  self._t(active))
        return logits

    def spec_verify(self, window, draft_len, active, temp, top_p, top_k):
        """One speculative verify window -> (tokens [S, k+1], n_accepted [S])."""
        self._count_active(active, 1)
        window, draft_len, active = self._t(window), self._t(draft_len), self._t(active)
        temp, top_p, top_k = self._sampling(temp, top_p, top_k)
        self.state, toks, n_acc = self.ops.spec_verify(
            self.params, self.state, window, draft_len, active, temp, top_p, top_k,
            generator=self.gen)
        return toks, n_acc

    def spec_multi(self, hist, hlen, active, temp, top_p, top_k, m: int, k: int, nmax: int):
        """m fused speculative windows, proposed on the device -> (toks_m
        [m,S,k+1], acc_m [m,S], drafted_m [m,S])."""
        self._count_active(active, m)
        hist, hlen, active = self._t(hist), self._t(hlen), self._t(active)
        temp, top_p, top_k = self._sampling(temp, top_p, top_k)
        self.state, *out = self.ops.spec_multi(
            self.params, self.state, hist, hlen, active, temp, top_p, top_k, m, k, nmax,
            generator=self.gen)
        return tuple(out)

    def reset_counts(self) -> None:
        """Zero this rank's counts, its flash kernels' launch counts and its
        card's peak memory."""
        self.counts = dict.fromkeys(COUNTS, 0)
        flash_attention.reset_launch_count()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def rank_counts(self) -> List[Dict[str, Any]]:
        """Every rank's counts since reset_counts, by rank (gathered on each):
        its replica, stage and tp index, COUNTS, B1a's launches in its
        process, the bytes of the weights it holds and its peak device
        memory in bytes (0 on the CPU)."""
        mine = dict(self.counts, rank=dist.get_rank() if self.mesh is not None else 0,
                    replica=self.replica, stage=self.stage, tp_rank=self.tp_index,
                    param_bytes=param_bytes(self.params),
                    flash_launches=flash_attention.launch_count(),
                    peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                                if self.device.type == "cuda" else 0))
        if self.mesh is None:
            return [mine]
        out: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        return out


# ------------------------------------------------------------- tensor parallelism

def _free_port() -> int:
    """A port no socket on this host holds now (bound at 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_copy(params):
    """A parameter dict on the CPU, to pickle into a follower's arguments."""
    if params is None:
        return None

    def cpu(v):
        return QTensor(v.q.cpu(), v.s.cpu()) if isinstance(v, QTensor) else v.cpu()

    return {name: ({k: cpu(v) for k, v in val.items()} if name == "layers" else cpu(val))
            for name, val in params.items()}


def _receive() -> tuple:
    msg: List[Any] = [None]
    dist.broadcast_object_list(msg, src=0)
    return msg[0]


def _mesh_spec(config: LLMConfig) -> MeshSpec:
    return MeshSpec(pp=config.pipeline_parallel_size, dp=config.data_parallel_size,
                    tp=config.tensor_parallel_size)


def follower_main(rank: int, init_method: str, devices: Sequence[str],
                  config: LLMConfig, params: Optional[Dict[str, Any]],
                  threads: int = 0) -> None:
    """A follower rank: join the mesh, build this rank's ShardRunner the way
    rank 0 builds its own, then make every announced call until "stop". Any
    exception prints its traceback and exits the process at once. `threads`
    (> 0) is rank 0's intra-op thread count, which the follower takes too:
    the ranks of one host would otherwise each start one thread per core."""
    try:
        if threads > 0:
            torch.set_num_threads(threads)
        mesh = build_mesh(_mesh_spec(config), devices, rank=rank, init_method=init_method)
        runner = ShardRunner(config, torch.device(devices[rank]), mesh, params)
        del params
        while True:
            op, args = _receive()
            if op == "stop":
                break
            getattr(runner, op)(*args)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Followers:
    """Rank 0's side of a multi-rank engine: starts len(devices) - 1 follower
    processes ("spawn"), P·D·T - 1 of them, joins them in a mesh of pp =
    pipeline_parallel_size, dp = data_parallel_size and tp =
    tensor_parallel_size as rank 0 (on devices[0]), and announces each call
    to them."""

    def __init__(self, config: LLMConfig, devices: Sequence[torch.device], params=None):
        names = [str(d) for d in devices]
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        ctx = multiprocessing.get_context("spawn")
        host_params = _host_copy(params)
        self.procs = [ctx.Process(target=follower_main, name=f"tp-follower-{r}", daemon=True,
                                  args=(r, init_method, names, config, host_params,
                                        torch.get_num_threads()))
                      for r in range(1, len(devices))]
        for p in self.procs:
            p.start()
        try:
            self.mesh = build_mesh(_mesh_spec(config), names, rank=0, init_method=init_method)
        except BaseException:
            self.kill()
            raise

    def dead(self) -> Optional[str]:
        """Why a follower is gone, or None while all run."""
        for p in self.procs:
            if p.exitcode is not None:
                return f"{p.name} exited with code {p.exitcode}"
        return None

    def announce(self, op: str, args: tuple) -> None:
        gone = self.dead()
        if gone:
            raise RuntimeError(f"tensor-parallel follower {gone}")
        if op == "install_transfer":  # the KV goes to its owner alone, point to point
            args = (args[0], None, None, *args[3:])
        dist.broadcast_object_list([(op, args)], src=0)

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(JOIN_S)

    def stop(self, announce: bool) -> None:
        """Send "stop" (when the group is still in step), join each follower
        within JOIN_S, kill the ones left, and leave the process group."""
        if announce and self.dead() is None:
            try:
                self.announce("stop", ())
            except RuntimeError:
                pass  # a follower went away meanwhile: the kill below covers it
        for p in self.procs:
            p.join(JOIN_S)
        self.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
