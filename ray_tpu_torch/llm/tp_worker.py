"""The device half of a TorchLLMEngine, and tensor parallelism's followers.

``ShardRunner`` holds what an engine keeps on its device: the weights (this
rank's shard under tensor parallelism), the KV state, the sampling
generator, and one method per model-runner or paged call the engine makes,
each taking host values (token lists, numpy arrays, ints) and returning
device tensors. The engine's scheduler, block manager and request
bookkeeping stay on the host of rank 0.

With ``tensor_parallel_size = N > 1`` the engine is rank 0 of an N-rank mesh
(``Followers``): it spawns N - 1 follower processes, each running
``follower_main``, and announces every call over the tp group (the op's
name and its small host arguments, ``broadcast_object_list``) before making
it itself; each follower makes the same call on its own ShardRunner, so the
collectives inside the model meet. Every rank holds the same all-gathered
logits and a generator seeded and advanced alike, so sampling inside a
fused burst stays in step; rank 0's host-side tokens ride in the next
call's arguments. A follower that raises prints its traceback and exits at
once, which fails rank 0's next collective ("connection closed") instead of
leaving it to wait. An idle engine pings the followers (``ping``) well
inside the group timeout, since a follower waiting for the next call is
inside a collective too.

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
from ray_tpu_torch.ops.quant import QTensor, quantize_llama_params
from ray_tpu_torch.parallel.mesh import GROUP_TIMEOUT_S, MeshSpec, build_mesh

from . import model_runner, paged
from .config import LLMConfig

# seconds an idle rank 0 lets pass between two calls before it pings its
# followers: well inside the group timeout a waiting follower is held to
PING_S = GROUP_TIMEOUT_S / 4
# seconds shutdown() waits for each follower to exit before it kills it
JOIN_S = 10.0


def load_params(config: LLMConfig, device, mesh=None, params=None):
    """The engine's weights on `device` in config.dtype (this rank's shard
    with a mesh), int8 when config.quantization says so: `params` (a whole
    parameter dict) placed, quantized whole on the device and then sharded;
    else a checkpoint directory's load or the seeded init, which quantize
    and shard piece by piece."""
    cfg = config.resolve_model_config()
    dtype = torch_dtype(config.dtype)
    int8 = bool(config.quantization)
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
            mesh=mesh)
    # int8: each layer quantized as it is drawn, never the whole float model
    return llama.init(cfg, seed=0, device=device, dtype=dtype, quantize_int8=int8,
                      mesh=mesh)


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
    (see load_params)."""

    def __init__(self, config: LLMConfig, device, mesh=None, params=None):
        self.config = config
        self.cfg = config.resolve_model_config()
        self.device = device
        self.mesh = mesh
        self.params = load_params(config, device, mesh, params)
        self.state = None  # model_runner.DecodeState | paged.PagedState
        self.pops: Optional[paged.PagedOps] = None
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(0)

    # -- helpers ------------------------------------------------------------------
    def _t(self, a, dtype=None) -> torch.Tensor:
        """A host array (or list) as a tensor on this rank's device."""
        t = torch.from_numpy(a) if isinstance(a, np.ndarray) else torch.as_tensor(a)
        return t.to(self.device) if dtype is None else t.to(self.device, dtype)

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

    # -- calls the engine makes (each announced to the followers under tp) ----------
    def ping(self) -> None:
        """Nothing: keeps a waiting follower inside its group timeout."""

    def init_state(self) -> None:
        """The decode KV state: the paged pool or the slot cache."""
        c = self.config
        if c.kv_layout == "paged":
            self.pops = paged.PagedOps(self.cfg, self.mesh)
            self.state = paged.init_paged_state(
                self.cfg, c.max_num_seqs, c.max_model_len, c.kv_pool_blocks(),
                c.kv_block_size, self.device, mesh=self.mesh)
        else:
            self.state = model_runner.init_state(self.cfg, c.max_num_seqs, c.max_model_len,
                                                 self.device, mesh=self.mesh)

    def prefill(self, prompt: List[int], slot: int, sampling) -> torch.Tensor:
        """Slot layout: the prompt into `slot`, whole or chunk by chunk (then
        installed at once) -> its first token [1]."""
        c = self.config
        if c.prefill_chunk and len(prompt) > c.prefill_chunk:
            # bounded activation memory; the assembled KV is installed at once
            k, v, last = self.prefill_kv(prompt)
            self.state = model_runner.install_kv(self.state, k, v, len(prompt), slot)
        else:
            self.state, last = model_runner.prefill(
                self.params, self.state, self.pad_to_bucket(prompt), len(prompt), slot,
                self.cfg, mesh=self.mesh)
        return self.sample_one(last, *sampling)

    def _install_paged(self, slot: int, k, v, n: int, block_ids: List[int]) -> None:
        k, v = _pad_blocks(k, v, len(block_ids), self.config.kv_block_size)
        self.state = self.pops.install_prefill(self.state, k, v, block_ids, n, slot,
                                               len(block_ids))

    def prefill_paged(self, prompt: List[int], slot: int, block_ids: List[int],
                      sampling) -> torch.Tensor:
        """Paged layout: the prompt into its allocated blocks -> its first token."""
        k, v, last = self.prefill_kv(prompt)
        self._install_paged(slot, k, v, len(prompt), block_ids)
        return self.sample_one(last, *sampling)

    def prefill_prefix(self, suffix: List[int], n: int, slot: int, cached_ids: List[int],
                       new_ids: List[int], sampling) -> torch.Tensor:
        """Paged layout with a prefix hit: the suffix over the cached blocks'
        KV into new blocks; the slot's table holds the cached ids, then the
        new -> the first token."""
        c = self.config
        k, v, last = self.pops.prefill_suffix_from_state(
            self.params, self.state, cached_ids, self.pad_to_bucket(suffix), len(suffix),
            len(cached_ids))
        k, v = _pad_blocks(k, v, len(new_ids), c.kv_block_size)
        row = np.zeros((c.max_model_len // c.kv_block_size,), np.int64)
        row[:len(cached_ids) + len(new_ids)] = cached_ids + new_ids
        self.state = self.pops.install_with_prefix(self.state, k, v, new_ids, row, n, slot,
                                                   len(new_ids))
        return self.sample_one(last, *sampling)

    def install_transfer(self, slot: int, k, v, n: int, block_ids: Optional[List[int]]):
        """A P/D transfer's KV (tensors or f32 numpy arrays) copied to the
        device and installed: into `block_ids` (paged) or `slot`."""
        k, v = ((x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x)))
                .to(self.device) for x in (k, v))
        if block_ids is not None:
            self._install_paged(slot, k, v, n, block_ids)
        else:
            self.state = model_runner.install_kv(self.state, k, v, n, slot)

    def append_block(self, slot: int, index: int, block_id: int) -> None:
        self.state = self.pops.append_block(self.state, slot, index, block_id)

    def decode(self, last, active, k_steps: int, temp, top_p, top_k, steps) -> torch.Tensor:
        """One decode step, or a fused burst of k_steps, for every slot ->
        the sampled tokens [k_steps, slots]."""
        last, active = self._t(last), self._t(active)
        temp, top_p, top_k = self._sampling(temp, top_p, top_k)
        if k_steps > 1:
            steps_left = self._t(steps)
            if self.pops is not None:
                self.state, toks = self.pops.decode_multi(
                    self.params, self.state, last, active, k_steps, temp, top_p, top_k,
                    steps_left, self.gen)
            else:
                self.state, toks = model_runner.decode_multi(
                    self.params, self.state, last, active, self.cfg, k_steps, temp, top_p,
                    top_k, steps_left, self.gen, mesh=self.mesh)
            return toks
        if self.pops is not None:
            self.state, logits = self.pops.decode_step(self.params, self.state, last, active)
        else:
            self.state, logits = model_runner.decode_step(self.params, self.state, last,
                                                          active, self.cfg, mesh=self.mesh)
        return model_runner.sample_tokens(logits, temp, top_p, top_k, self.gen)[None, :]

    def spec_verify(self, window, draft_len, active, temp, top_p, top_k):
        """One speculative verify window -> (tokens [S, k+1], n_accepted [S])."""
        window, draft_len, active = self._t(window), self._t(draft_len), self._t(active)
        temp, top_p, top_k = self._sampling(temp, top_p, top_k)
        if self.pops is not None:
            self.state, toks, n_acc = self.pops.spec_verify(
                self.params, self.state, window, draft_len, active, temp, top_p, top_k,
                generator=self.gen)
        else:
            self.state, toks, n_acc = model_runner.spec_verify_step(
                self.params, self.state, window, draft_len, active, self.cfg, temp, top_p,
                top_k, generator=self.gen, mesh=self.mesh)
        return toks, n_acc

    def spec_multi(self, hist, hlen, active, temp, top_p, top_k, m: int, k: int, nmax: int):
        """m fused speculative windows, proposed on the device -> (toks_m
        [m,S,k+1], acc_m [m,S], drafted_m [m,S])."""
        hist, hlen, active = self._t(hist), self._t(hlen), self._t(active)
        temp, top_p, top_k = self._sampling(temp, top_p, top_k)
        if self.pops is not None:
            self.state, *out = self.pops.spec_multi(
                self.params, self.state, hist, hlen, active, temp, top_p, top_k, m, k, nmax,
                generator=self.gen)
        else:
            self.state, *out = model_runner.spec_multi(
                self.params, self.state, hist, hlen, active, self.cfg, temp, top_p, top_k,
                m, k, nmax, generator=self.gen, mesh=self.mesh)
        return tuple(out)


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


def _receive(group) -> tuple:
    msg: List[Any] = [None]
    dist.broadcast_object_list(msg, src=0, group=group)
    return msg[0]


def follower_main(rank: int, init_method: str, devices: Sequence[str],
                  config: LLMConfig, params: Optional[Dict[str, Any]]) -> None:
    """A follower rank: join the mesh, build this rank's ShardRunner the way
    rank 0 builds its own, then make every announced call until "stop". Any
    exception prints its traceback and exits the process at once."""
    try:
        mesh = build_mesh(MeshSpec(tp=len(devices)), devices, rank=rank,
                          init_method=init_method)
        runner = ShardRunner(config, torch.device(devices[rank]), mesh, params)
        del params
        group = mesh.get_group("tp")
        while True:
            op, args = _receive(group)
            if op == "stop":
                break
            getattr(runner, op)(*args)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Followers:
    """Rank 0's side of tensor parallelism: starts len(devices) - 1 follower
    processes ("spawn"), joins them in a mesh of tp = len(devices) as rank 0
    (on devices[0]), and announces each call to them."""

    def __init__(self, config: LLMConfig, devices: Sequence[torch.device], params=None):
        names = [str(d) for d in devices]
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        ctx = multiprocessing.get_context("spawn")
        host_params = _host_copy(params)
        self.procs = [ctx.Process(target=follower_main, name=f"tp-follower-{r}", daemon=True,
                                  args=(r, init_method, names, config, host_params))
                      for r in range(1, len(devices))]
        for p in self.procs:
            p.start()
        try:
            self.mesh = build_mesh(MeshSpec(tp=len(devices)), names, rank=0,
                                   init_method=init_method)
        except BaseException:
            self.kill()
            raise
        self._group = self.mesh.get_group("tp")

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
        dist.broadcast_object_list([(op, args)], src=0, group=self._group)

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
