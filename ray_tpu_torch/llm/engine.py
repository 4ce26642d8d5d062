"""LLMEngine ABC + TorchLLMEngine: continuous batching on one CUDA device or
a mesh of pipeline-, data- and tensor-parallel ranks (port of
ray_tpu/llm/engine.py, slot and paged layouts).

A scheduler thread (1) admits waiting requests into free cache slots with a
whole-prompt prefill padded to a bucket, or a chunked one, (2) advances every
active slot with one decode step, or a fused K-step decode+sample burst with
one host sync, and (3) streams tokens out through per-request queues.
Requests admit, retire and abort at burst boundaries without draining the
batch, and a per-slot step budget keeps one near-finished request from
collapsing the burst width.

With kv_layout="paged" the KV lives in a shared block pool (llm/paged.py):
blocks are allocated at admission and grown before each burst; a dry pool
preempts the youngest request, which is prefilled again later from its token
history; full prompt blocks are shared through the prefix cache when the hit
pays for itself (the pay-or-skip gate).

With num_speculative_tokens = k the decode step is n-gram speculation: the
host proposes up to k drafts per greedy slot from its token history, one
verify forward scores the window and the accepted prefix plus a bonus token
emit at once; with a fused burst width m > 1 the proposal runs on the device
too, m windows per host sync. quantization="int8" stores the layer matmuls
(expert stacks included) and an untied head as int8 with per-output-channel
scales (W8A16): given weights are quantized once they are on the device,
and the seeded init and a checkpoint's load quantize each layer (each
expert) as it is drawn or read, so a model whose float copy would not fit
the card (mixtral-8x7b) starts in int8. A checkpoint directory as
``model_source`` is loaded at start (models/checkpoint.py).
Mixture-of-experts configs run in both layouts, with speculation and int8.

P/D disaggregation: ``prefill_only`` on a prefill engine (weights only, no
KV state) returns the prompt's KV as CPU tensors with the first sampled
token; ``generate_from_prefill`` on a decode engine installs that KV at
admission, in the loop thread, and decodes from it. The KV travels on the
host path, as the JAX engine's does when its device plane is down; the
device-plane handoff (``kv_handle`` results, paged streaming) is ROADMAP A10.
``metrics()`` has every key of the JAX engine's; its Prometheus export and
the request spans are ROADMAP A11.

Every device call goes through ``_run(op, *args)`` on the engine's
``tp_worker.ShardRunner``, with host arguments. With pipeline_parallel_size ×
data_parallel_size × tensor_parallel_size = N > 1 the engine is rank 0 of an
N-rank mesh over ``devices`` (cuda:0..N-1 by default; gloo when ranks share a
card or run on the CPU): ``start()`` spawns N - 1 followers, ``_run`` announces each call to
them first, and ``shutdown()`` stops, joins and, past a timeout, kills them.
A follower's death or exception, or any failed call on the mesh, finishes
the in-flight requests with "error" (within the group timeout), fails every
later one, and makes ``health_error()`` say why. P/D under tp > 1 or pp > 1
is ROADMAP A6.

Data parallelism (data_parallel_size = D > 1): D replicas, each with
max_num_seqs / D slots of the one scheduler; with kv_layout="paged" each
has a pool of num_kv_blocks / D blocks and a prefix cache of its own (the
block manager's ``_ShardedBlockManager``). The engine calls only the block
manager's slot-scoped forms where pool locality matters, so dp needs no
branch here beyond admission, which takes the replica with the most free
blocks first, and preemption, which picks its victim in the growing slot's
pool.

Pipeline parallelism (pipeline_parallel_size = P > 1): each replica is P
stages of n_layers / P layers and their KV (tp_worker.py); the scheduler is
the same. Decode keeps per-step scheduling, as in the JAX engine: a fused
burst width, auto or fixed, is downgraded to 1 at start with one INFO line,
and speculation runs one verify window per step.
"""
from __future__ import annotations

import abc
import collections
import dataclasses
import itertools
import logging
import queue
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device

from . import paged
from .model_runner import slot_replica
from . import config as llm_config
from .config import (ENGINE_IDLE_WAIT_S, FUSED_STEPS_MAX, FUSED_SYNC_TARGET,
                     LLMConfig, SamplingParams)
from .tokenizer import get_tokenizer
from .tp_worker import PING_S, Followers, ShardRunner

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass
class RequestOutput:
    """One streamed chunk: the tokens emitted since the previous chunk."""

    request_id: str
    token_ids: List[int]
    text: str = ""
    finished: bool = False
    finish_reason: Optional[str] = None  # "stop" | "length" | "abort" | "error"
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0


class LLMEngine(abc.ABC):
    """Engine interface (reference llm_engine.py:15)."""

    @abc.abstractmethod
    def start(self) -> None: ...

    @abc.abstractmethod
    def generate(self, prompt: Any, params: SamplingParams, request_id: Optional[str] = None
                 ) -> Iterator[RequestOutput]: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...


def _sampling(p: SamplingParams) -> tuple:
    """A request's (temperature, top_p, top_k), as the runner's calls take them."""
    return (p.temperature, p.top_p, p.top_k)


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1): burst widths are powers of two."""
    return 1 << (max(1, int(n)).bit_length() - 1)


class _Request:
    def __init__(self, req_id: str, prompt_ids: List[int], params: SamplingParams,
                 prefill_kv=None):
        self.id = req_id
        self.prompt_ids = prompt_ids
        self.params = params
        self.out_queue: "queue.Queue[RequestOutput]" = queue.Queue()
        self.generated = 0
        self.slot = -1
        # prompt + every emitted token: a preempted request is prefilled
        # again from it
        self.token_history: List[int] = list(prompt_ids)
        self.admitted_at = 0  # admission order; preemption takes the youngest
        self.prefill_tokens = 0  # tokens the last admission's prefill computed
        # (k, v, first_token) of a P/D transfer, installed at admission
        self.prefill_kv = prefill_kv


class TorchLLMEngine(LLMEngine):
    """Continuous batching over model_runner's (slot) or paged's prefill/decode.

    `params` (a llama parameter dict of tensors) replaces the random init from
    seed 0; either way the weights are stored in ``config.dtype`` at start.
    int8 ``QTensor`` leaves in `params` (an engine's quantized weights, or a
    bridged int8 tree) are moved to the device as they are.
    `device` defaults to CUDA and raises when there is none; pass "cpu" for
    the plain path. With N = pipeline_parallel_size × data_parallel_size ×
    tensor_parallel_size > 1, `devices` names rank r's device for each of the
    N ranks (this process is rank 0; rank r is stage r // (dp × tp) of
    replica r // tp % dp); it defaults to N CPU ranks when `device` is
    "cpu", else to cuda:0..N-1."""

    def __init__(self, config: LLMConfig, params=None, device=None, devices=None):
        self.config = config
        self.model_config = config.resolve_model_config()
        self.tokenizer = get_tokenizer(config.resolve_tokenizer_name())
        pp, tp, dp = (config.pipeline_parallel_size, config.tensor_parallel_size,
                      config.data_parallel_size)
        n = pp * dp * tp
        if devices is None and n > 1:
            cpu = device is not None and torch.device(device).type == "cpu"
            devices = ["cpu"] * n if cpu else [f"cuda:{r}" for r in range(n)]
        if devices is not None:
            if len(devices) != n:
                stages = f"pipeline_parallel_size {pp} × " if pp > 1 else ""
                raise ValueError(f"{len(devices)} devices for {stages}tensor_parallel_size "
                                 f"{tp} × data_parallel_size {dp}")
            devices = [resolve_device(d) for d in devices]
            device = devices[0]
        self.device = resolve_device(device)
        self.devices = devices
        self._params_in = params
        self._runner: Optional[ShardRunner] = None
        self._followers: Optional[Followers] = None
        self._run_lock = threading.Lock()
        self._tp_error: Optional[str] = None  # why the tensor-parallel group failed
        self._last_run = time.monotonic()
        self._started = False
        self._shutdown = False
        self._waiting: "queue.Queue[_Request]" = queue.Queue()
        self._active: Dict[int, Optional[_Request]] = {}
        self._lock = threading.Lock()
        self._start_lock = threading.Lock()
        self._loop_thread: Optional[threading.Thread] = None
        self._wakeup = threading.Event()
        self._admitting: Optional[_Request] = None  # mid-admission request
        # live requests by id (waiting or active); abort() only marks ids found
        # here, so a stale abort can never poison a later request reusing the id
        self._requests: Dict[str, _Request] = {}
        self._aborted: set = set()
        self._blocks = None  # paged: the host-side block manager
        self._admissions = itertools.count(1)
        self._fused_auto = False
        self._fused_fixed = 1
        self._host_rt_s = 0.0  # measured tiny dispatch+fetch round trip
        self._step_s = 0.0  # EWMA of per-decode-step device time
        self._prefill_per_tok_s = 0.0  # EWMA of prefill time per computed token
        self._k_seen: set = set()  # burst widths already run (first is warm-up)
        self._last_tick_monotonic = time.monotonic()  # loop liveness (check_health)
        self.num_prefills = 0  # prefills this engine computed (not P/D installs)
        self.num_pending = 0
        self.num_active = 0
        self.total_generated = 0
        self.num_preemptions = 0
        self.num_aborted = 0
        self.num_prefix_skipped = 0
        self.num_spec_drafted = 0
        self.num_spec_accepted = 0
        # KV exports this engine pins for a decode engine's pull: the host
        # path pins nothing, so it stays empty (the device plane is ROADMAP A10)
        self._pd_exports: List[bytes] = []

    # -- lifecycle ---------------------------------------------------------------
    def start(self) -> None:
        """Place the weights on the device in config.dtype, then quantize them
        when config.quantization says so (thread-safe, idempotent); a
        checkpoint directory's load and the seeded init quantize piece by
        piece as they go. The KV state and the scheduler loop start on first
        use; with more than one rank the followers start here, and the KV
        state and the loop with them (P/D, which needs neither, is not
        served under tp)."""
        with self._start_lock:
            if self._started:
                return
            c = self.config
            k_cfg = c.resolve_decode_steps()
            self._fused_auto = k_cfg == 0
            self._fused_fixed = 1 if self._fused_auto else _pow2_floor(k_cfg)
            if c.pipeline_parallel_size > 1 and (self._fused_auto or self._fused_fixed > 1):
                # pp decode keeps per-step scheduling (ray_tpu/llm/engine.py:258-269)
                LOGGER.info(
                    "llm.engine model=%s: pipeline_parallel_size=%d keeps per-step decode "
                    "scheduling; fused multi-step decode (num_decode_steps=%s) downgraded to 1",
                    c.model_id, c.pipeline_parallel_size,
                    "auto" if self._fused_auto else self._fused_fixed)
                self._fused_auto, self._fused_fixed = False, 1
            if c.quantization and c.quantization != "int8":
                # before any checkpoint byte is read (ray_tpu/llm/engine.py:303)
                raise ValueError(f"unknown quantization {c.quantization!r} (supported: int8)")
            mesh = None
            if c.pipeline_parallel_size * c.data_parallel_size * c.tensor_parallel_size > 1:
                if self.device.type == "cuda":
                    from ray_tpu_torch.ops import _build

                    _build.build("flash_fwd")  # once, before N processes load it
                self._followers = Followers(c, self.devices, self._params_in)
                mesh = self._followers.mesh
            try:
                self._runner = ShardRunner(c, self.device, mesh, self._params_in)
            except BaseException:
                self._stop_followers(announce=False)
                raise
            self._params_in = None
            self._active = {s: None for s in range(c.max_num_seqs)}
            n = c.max_num_seqs
            # host mirrors of per-slot sampling params
            self._temp = np.zeros((n,), np.float32)
            self._top_p = np.ones((n,), np.float32)
            self._top_k = np.zeros((n,), np.int64)
            self._last_tokens = np.zeros((n,), np.int64)
            self._slots_per = n // c.data_parallel_size
            self._replica_tokens = [0] * c.data_parallel_size  # tokens emitted, by replica
            self._started = True
        if self._followers is not None:
            self._ensure_decode_started()

    @property
    def params(self):
        """This rank's weights (None before start)."""
        return None if self._runner is None else self._runner.params

    @property
    def state(self):
        """The decode KV state on this rank (None before first decode use)."""
        return None if self._runner is None else self._runner.state

    def _run(self, op: str, *args):
        """Make one device call on the ShardRunner; under tensor parallelism
        announce it to the followers first. Any failure under tp leaves the
        group out of step: the followers are killed and every later call
        raises."""
        if self._followers is None:
            return getattr(self._runner, op)(*args)
        with self._run_lock:
            if self._tp_error is not None:
                raise RuntimeError(f"the tensor-parallel group failed: {self._tp_error}")
            self._last_run = time.monotonic()
            try:
                self._followers.announce(op, args)
                return getattr(self._runner, op)(*args)
            except Exception as e:
                self._tp_error = f"{op}: {e!r}"
                self._followers.kill()
                raise

    def _run_local(self, op: str, *args):
        """A call on rank 0's ShardRunner alone, not announced: one that no
        other rank takes part in (P/D's prefill, which is refused under tp)."""
        with self._run_lock:
            return getattr(self._runner, op)(*args)

    def rank_counts(self, reset: bool = False) -> List[Dict[str, Any]]:
        """Each rank's counts (tp_worker.ShardRunner.rank_counts: its replica
        and tp index, the prefills it computed, the decode steps in which its
        replica had an active slot, B1a's launches in its process, its peak
        device memory) and the tokens its replica's requests were given
        since the last reset; `reset` zeroes them after."""
        self.start()
        out = self._run("rank_counts")
        for rank in out:
            rank["tokens"] = self._replica_tokens[rank["replica"]]
        if reset:
            self._run("reset_counts")
            self._replica_tokens = [0] * len(self._replica_tokens)
        return out

    def health_error(self) -> Optional[str]:
        """Why the engine cannot serve (its tensor-parallel group failed or
        a follower is gone), or None."""
        if self._tp_error is not None:
            return f"tensor-parallel group failed: {self._tp_error}"
        gone = self._followers.dead() if self._followers is not None else None
        return f"tensor-parallel follower {gone}" if gone else None

    def _stop_followers(self, announce: bool) -> None:
        f, self._followers = self._followers, None
        if f is not None:
            f.stop(announce)

    def _ensure_decode_started(self) -> None:
        """Allocate the decode KV state + scheduler loop on first decode use."""
        with self._start_lock:
            if self._loop_thread is not None:
                return
            c = self.config
            if self.state is None:
                if c.kv_layout == "paged":
                    self._blocks = paged.make_block_manager(
                        c.kv_pool_blocks(), c.kv_block_size,
                        c.max_model_len // c.kv_block_size, c.max_num_seqs,
                        dp=c.data_parallel_size,
                        enable_prefix_caching=c.enable_prefix_caching)
                self._run("init_state")
            self._measure_host_rt()
            self._loop_thread = threading.Thread(target=self._loop, daemon=True,
                                                 name="llm-engine")
            self._loop_thread.start()

    def shutdown(self) -> None:
        """Stop the loop; under tp, stop the followers (joined within a
        timeout, then killed) and leave the process group."""
        self._shutdown = True
        self._wakeup.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
        if self._followers is not None:
            in_step = self._tp_error is None and self._run_lock.acquire(timeout=5)
            try:
                self._stop_followers(announce=in_step)
            finally:
                if in_step:
                    self._run_lock.release()

    # -- fused-burst auto-tune ----------------------------------------------------
    def _measure_host_rt(self, samples: int = 3) -> None:
        """The fixed per-dispatch host round trip (launch + fetch of a scalar):
        the cost a fused burst amortises."""
        x = torch.zeros((), dtype=torch.int32, device=self.device)
        (x + 1).item()  # warm-up outside the timed region
        best = float("inf")
        for _ in range(samples):
            t0 = time.perf_counter()
            (x + 1).item()
            best = min(best, time.perf_counter() - t0)
        self._host_rt_s = max(best, 1e-7)

    def decode_steps_target(self) -> int:
        """Current fused burst width target (power of two): fixed K when
        configured; in auto mode the smallest K that brings the host-sync
        share of a burst, rt/(rt + K*step), down to the target fraction."""
        if not self._fused_auto:
            return self._fused_fixed
        rt, step = self._host_rt_s, self._step_s
        if rt <= 0 or step <= 0:
            return 1  # unmeasured yet: first bursts run per-step and probe
        f = FUSED_SYNC_TARGET
        need = rt * (1.0 - f) / (f * step)
        if need <= 1.0:
            return 1
        k = 1 << int(np.ceil(np.log2(need)))
        return max(1, min(k, FUSED_STEPS_MAX))

    def _note_burst_device_wall(self, k: int, wall_s: float) -> None:
        """Fold one burst's dispatch->fetch wall time into the device-step
        EWMA (wall = rt + K*step); the first burst at each K is a warm-up."""
        if k not in self._k_seen:
            self._k_seen.add(k)
            return
        est = max((wall_s - self._host_rt_s) / k, 1e-6)
        self._step_s = est if self._step_s <= 0 else 0.5 * est + 0.5 * self._step_s

    def decode_host_sync_fraction(self) -> float:
        """Estimated share of decode wall time spent on the host round trip
        at the current burst width (the quantity auto-K minimizes)."""
        rt, step = self._host_rt_s, self._step_s
        if rt <= 0 or step <= 0:
            return 0.0
        k = self.decode_steps_target()
        return rt / (rt + k * step)

    def _slot_steps_left(self, req: _Request) -> int:
        """Decode steps this request can still take: its max_tokens budget
        capped by the KV room left in its slot (both >= 1 while it is live)."""
        next_write = len(req.prompt_ids) + req.generated - 1
        kv_room = (self.config.max_model_len - 1) - next_write
        budget = req.params.max_tokens - req.generated
        return max(1, min(kv_room, budget))

    def _burst_plan(self):
        """(k_steps, steps_left[slots]) for the next burst: K is the target
        capped by the longest-running slot's budget; each slot's own budget
        rides along as steps_left."""
        n = self.config.max_num_seqs
        steps = np.ones((n,), np.int64)
        max_sl = 0
        for slot, req in self._active.items():
            if req is None:
                continue
            sl = self._slot_steps_left(req)
            steps[slot] = sl
            max_sl = max(max_sl, sl)
        k = _pow2_floor(min(self.decode_steps_target(), max(1, max_sl)))
        np.minimum(steps, k, out=steps)
        return k, steps

    def _encode_prompt(self, prompt, params: SamplingParams) -> List[int]:
        """Tokenize + truncate so the generation fits max_model_len."""
        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        limit = max(1, self.config.max_model_len - params.max_tokens)
        return ids[-limit:] if len(ids) > limit else ids

    # -- API ---------------------------------------------------------------------
    def generate(self, prompt, params: SamplingParams, request_id: Optional[str] = None
                 ) -> Iterator[RequestOutput]:
        self.start()
        self._ensure_decode_started()
        prompt_ids = self._encode_prompt(prompt, params)
        yield from self._submit(_Request(request_id or uuid.uuid4().hex, prompt_ids, params))

    def _submit(self, req: _Request) -> Iterator[RequestOutput]:
        """Queue `req` now -> the stream of its outputs, to the finished one."""
        with self._lock:
            self.num_pending += 1
            self._requests[req.id] = req
        if self._tp_error is not None:  # nothing more runs on a failed group
            self._fail_request(req, "error")
            return iter([req.out_queue.get()])
        self._waiting.put(req)
        self._wakeup.set()

        def stream() -> Iterator[RequestOutput]:
            while True:
                out = req.out_queue.get()
                yield out
                if out.finished:
                    return

        return stream()

    # -- P/D disaggregation, host path (ray_tpu/llm/engine.py:555-792) -------------
    def prefill_only(self, prompt, params: SamplingParams,
                     force_host: bool = False) -> Dict[str, Any]:
        """Prefill a prompt and return its KV with the first sampled token,
        for generate_from_prefill on a decode engine. The engine holds its
        weights and nothing else: no decode state is allocated. The KV is
        chunk-aware (prefill_chunk) and, with kv_layout="paged", trimmed to
        the blocks the decode side installs; it leaves as CPU tensors in
        the engine's dtype, which pickle. -> {"prompt_ids", "first_token",
        "k", "v"} and "first_text" when the first token renders alone (not a
        stop token, not a partial UTF-8 codepoint). Every result takes the
        host path, so `force_host` changes nothing here."""
        self._refuse_pd_on_a_mesh()
        self.start()
        prompt_ids = self._encode_prompt(prompt, params)
        k, v, last_logits = self._run_local("prefill_kv", prompt_ids)
        tok = int(self._run_local("sample_one", last_logits, *_sampling(params))[0])
        with self._lock:
            self.num_prefills += 1
        out: Dict[str, Any] = {"prompt_ids": prompt_ids, "first_token": tok}
        stops = params.stop_token_ids or [self.tokenizer.eos_token_id]
        if tok not in stops:
            txt = self.tokenizer.decode([tok])
            if txt and not txt.endswith("\ufffd"):
                out["first_text"] = txt
        if self.config.kv_layout == "paged":
            k, v = paged.trim_kv_for_transfer(k, v, len(prompt_ids), self.config.kv_block_size)
        # compact host copies: a trimmed view would pickle its whole storage
        out["k"], out["v"] = k.cpu().contiguous(), v.cpu().contiguous()
        return out

    def release_prefill_export(self, key_hex: str) -> None:
        """Decode-side ack of a pulled export: the host path pins nothing,
        so the key leaves the (empty) export list and nothing is released."""
        key = bytes.fromhex(key_hex)
        with self._lock:
            self._pd_exports[:] = [e for e in self._pd_exports if e != key]

    def generate_from_prefill(self, prefill_result: Dict[str, Any], params: SamplingParams,
                              request_id: Optional[str] = None) -> Iterator[RequestOutput]:
        """Continue decoding from a transferred prefill (prefill_only's
        result; k and v as tensors or f32 numpy arrays). The KV is copied to
        the device and installed at admission, in the loop thread, and the
        first token the prefill side sampled is emitted first. Raises at the
        call, not at the first next(), for a device-plane handle."""
        if "kv_handle" in prefill_result:
            raise NotImplementedError("device-plane KV handoff: ROADMAP A10")
        self._refuse_pd_on_a_mesh()
        self.start()
        self._ensure_decode_started()
        return self._submit(_Request(
            request_id or uuid.uuid4().hex, list(prefill_result["prompt_ids"]), params,
            prefill_kv=(prefill_result["k"], prefill_result["v"],
                        int(prefill_result["first_token"]))))

    def _refuse_pd_on_a_mesh(self) -> None:
        """P/D is not served under tensor or pipeline parallelism (its KV
        would leave and arrive in shards or stages): ROADMAP A6 item 2."""
        c = self.config
        for size, what in ((c.tensor_parallel_size, "tensor"),
                           (c.pipeline_parallel_size, "pipeline")):
            if size > 1:
                raise NotImplementedError(
                    f"P/D (prefill_only / generate_from_prefill) under {what} parallelism: "
                    "ROADMAP A6")

    def generate_sync(self, prompt, params: SamplingParams) -> RequestOutput:
        """Collect the full generation into one RequestOutput."""
        ids: List[int] = []
        last = None
        for chunk in self.generate(prompt, params):
            ids.extend(chunk.token_ids)
            last = chunk
        return RequestOutput(
            request_id=last.request_id, token_ids=ids, text=self.tokenizer.decode(ids),
            finished=True, finish_reason=last.finish_reason,
            num_prompt_tokens=last.num_prompt_tokens, num_generated_tokens=len(ids))

    def metrics(self) -> Dict[str, Any]:
        """The JAX engine's metrics() keys: request counts, preemptions,
        aborts, speculation and prefix-gate counters, pinned P/D exports,
        the fused burst width and where decode wall time goes and, with
        kv_layout="paged", the pool's occupancy and the prefix cache's
        hits. (The JAX engine also exports them as Prometheus gauges:
        ROADMAP A11.)"""
        out: Dict[str, Any] = {
            "num_pending": self.num_pending,
            "num_active": self.num_active,
            "total_generated": self.total_generated,
            "num_preemptions": self.num_preemptions,
            "num_aborted": self.num_aborted,
            "num_spec_drafted": self.num_spec_drafted,
            "num_spec_accepted": self.num_spec_accepted,
            "num_prefix_skipped": self.num_prefix_skipped,
            "pd_exports_live": len(self._pd_exports),
            "decode_fused_steps": self.decode_steps_target(),
            "decode_host_sync_fraction": round(self.decode_host_sync_fraction(), 4),
            "decode_host_rt_ms": round(self._host_rt_s * 1e3, 4),
            "decode_device_step_ms": round(self._step_s * 1e3, 4),
        }
        blocks = self._blocks
        if blocks is not None:
            total, free = blocks.total_blocks, blocks.num_free
            out.update({
                "kv_blocks_total": total,
                "kv_blocks_free": free,
                "kv_pool_occupancy": (total - free) / total if total else 0.0,
                "prefix_cache_hit_tokens": blocks.hit_tokens,
                "prefix_cached_blocks": len(blocks.cached),
            })
        return out

    def abort(self, request_id: str) -> None:
        """Cancel a request: a waiting one is failed at admission; an active
        one frees its slot at the next scheduler tick."""
        with self._lock:
            if request_id not in self._requests:
                return  # already finished (or unknown): nothing to cancel
            self._aborted.add(request_id)
        self._wakeup.set()

    # -- scheduler -----------------------------------------------------------------
    def _finish_abort(self, req: _Request) -> bool:
        """If `req` was cancelled, finish it now and return True."""
        with self._lock:
            if req.id not in self._aborted:
                return False
        req.out_queue.put(RequestOutput(
            request_id=req.id, token_ids=[], finished=True, finish_reason="abort",
            num_prompt_tokens=len(req.prompt_ids), num_generated_tokens=req.generated))
        self.num_aborted += 1
        self._release(req)
        with self._lock:
            self._aborted.discard(req.id)
        return True

    def _process_aborts(self) -> None:
        with self._lock:
            if not self._aborted:
                return
        for req in list(self._active.values()):
            if req is not None:
                self._finish_abort(req)

    def _fail_request(self, req: _Request, reason: str) -> None:
        req.out_queue.put(RequestOutput(
            request_id=req.id, token_ids=[], finished=True, finish_reason=reason,
            num_prompt_tokens=len(req.prompt_ids), num_generated_tokens=req.generated))
        with self._lock:
            self.num_pending -= 1
            self._requests.pop(req.id, None)
            self._aborted.discard(req.id)

    def _admit(self) -> None:
        """Admit waiting requests into free slots (the JAX engine's
        ``_admit_inner``): a P/D transfer's KV is installed as it is; else
        the prompt is prefilled into blocks (paged), chunk by chunk into a
        slot, or whole into a slot. A paged request the pool cannot take yet
        goes back to the queue, and admission stops for this cycle."""
        c = self.config
        while True:
            slot = self._next_free_slot()
            if slot is None:
                return
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                was_aborted = req.id in self._aborted
                self._aborted.discard(req.id)
            if was_aborted:
                self.num_aborted += 1
                self._fail_request(req, "abort")
                continue
            # visible to the loop's crash handler: in neither _waiting nor _active
            self._admitting = req
            p = req.params
            t0 = time.perf_counter()
            req.prefill_tokens = len(req.prompt_ids)
            transferred = req.prefill_kv is not None
            if transferred:
                tok = self._install_transfer(req, slot)
                if tok is None:
                    self._admitting = None
                    if c.kv_layout == "paged":
                        return  # requeued (pool busy) or failed: stop admitting
                    continue  # failed: wider than the slot
            elif c.kv_layout == "paged":
                tok = self._prefill_paged(req, slot)
                if tok is None:
                    self._admitting = None
                    return  # requeued (pool busy) or failed: stop admitting
            else:
                # whole, or chunk by chunk (bounded activation memory) and
                # then installed at once
                tok = int(self._run("prefill", req.prompt_ids, slot, _sampling(p))[0])
            self._note_prefill(req, time.perf_counter() - t0)
            if not transferred:
                self.num_prefills += 1
            req.slot = slot
            req.admitted_at = next(self._admissions)
            self._active[slot] = req
            self._temp[slot], self._top_p[slot], self._top_k[slot] = (
                p.temperature, p.top_p, p.top_k)
            self._last_tokens[slot] = tok
            with self._lock:
                self.num_pending -= 1
                self.num_active += 1
            self._admitting = None
            self._emit(req, tok)

    def _next_free_slot(self) -> Optional[int]:
        """The free slot the next admission takes, or None. Under dp > 1 it
        is in the replica with the most free blocks (paged, as
        ray_tpu/llm/engine.py:1041-1048 ranks them, so one full pool does not
        block admission to the others) or free slots (slot layout); ties keep
        slot order. The rank is taken anew for each admission, where the JAX
        engine ranks once per cycle, so requests that arrive together spread
        over the replicas instead of filling the first."""
        free = [s for s, r in self._active.items() if r is None]
        c = self.config
        if c.data_parallel_size == 1 or not free:
            return free[0] if free else None
        if c.kv_layout == "paged":
            return max(free, key=self._blocks.num_free_for)  # the first of equals
        per = self._slots_per
        idle = collections.Counter(slot_replica(s, per)[0] for s in free)
        return max(free, key=lambda s: idle[slot_replica(s, per)[0]])

    def _install_transfer(self, req: _Request, slot: int) -> Optional[int]:
        """Install a P/D transfer's KV (ray_tpu/llm/engine.py:1115-1142) and
        return the first token the prefill side sampled, or None when the
        request was not admitted: requeued with its KV (paged pool busy) or
        failed with "length" (wider than a slot can hold). The host-to-device
        copy happens here, in the loop thread."""
        c = self.config
        k, v, tok = req.prefill_kv
        n = len(req.prompt_ids)
        if c.kv_layout == "paged":
            needed = self._blocks.blocks_needed(max(n + 1, k.shape[2]))
            if needed > self._blocks.max_fit(slot):
                self._fail_request(req, "length")  # can never fit
                return None
            if not self._blocks.can_allocate_for(slot, needed):
                self._waiting.put(req)  # prefill_kv intact; retried next cycle
                return None
            self._run("install_transfer", slot, k, v, n, self._blocks.allocate(slot, needed))
        elif k.shape[2] > c.max_model_len:
            # a transfer padded past this engine's slot width fails only
            # this request (install_kv would raise in the loop)
            self._fail_request(req, "length")
            return None
        else:
            self._run("install_transfer", slot, k, v, n, None)
        req.prefill_kv = None
        return tok

    def _note_prefill(self, req: _Request, wall_s: float) -> None:
        """Fold one admission's prefill wall time into the per-computed-token
        EWMA that the prefix cache's pay-or-skip gate reads (the dispatch
        round trip subtracted). A first call's warm-up inflates it, which
        only biases the gate toward using the cache."""
        per_tok = max((wall_s - self._host_rt_s) / max(1, req.prefill_tokens), 1e-9)
        self._prefill_per_tok_s = per_tok if self._prefill_per_tok_s <= 0 else (
            0.3 * per_tok + 0.7 * self._prefill_per_tok_s)

    # -- paged KV (ray_tpu/llm/engine.py:1195-1450) --------------------------------
    def _prefill_paged(self, req: _Request, slot: int) -> Optional[int]:
        """Prefill into allocated blocks -> the first sampled token, or None
        when the request was not admitted (requeued or failed). With the
        prefix cache, a prompt that shares full leading blocks with an
        earlier one skips their recomputation: the cached blocks join the
        slot's table by reference and the model runs only over the suffix."""
        c = self.config
        prompt = req.token_history if req.generated else req.prompt_ids
        n = len(prompt)
        chunk, bs = c.prefill_chunk, c.kv_block_size
        cached_ids: List[int] = []
        min_hit = self._prefix_min_hit_tokens()
        max_hit = ((n - 1) // bs) * bs  # full blocks; the last token is always computed
        if c.enable_prefix_caching and max_hit >= bs:
            # pay-or-skip: use the cache only when the tokens it saves
            # (hit x measured per-token prefill) clear one dispatch round trip
            if max_hit < min_hit:
                self.num_prefix_skipped += 1
            else:
                cached_ids = self._blocks.match_prefix(slot, prompt)
                if cached_ids and len(cached_ids) * bs < min_hit:
                    self._blocks.release(slot)  # detach: the hit is too small to pay
                    cached_ids = []
                    self.num_prefix_skipped += 1
        req.prefill_tokens = n - len(cached_ids) * bs
        if cached_ids:
            if not chunk or req.prefill_tokens <= chunk:
                return self._prefill_with_prefix(req, slot, prompt, cached_ids)
            # the suffix is still too long for one pass: chunked prefill of
            # the whole prompt, with the attached prefix released
            self._blocks.release(slot)
            req.prefill_tokens = n
        s_pad = (-(-n // chunk) * chunk if chunk and n > chunk
                 else next(b for b in c.buckets() if b >= n))
        needed = self._blocks.blocks_needed(max(n + 1, s_pad))
        if needed > self._blocks.max_fit(slot):
            self._fail_request(req, "length")  # can never fit
            return None
        if not self._blocks.can_allocate_for(slot, needed):
            self._waiting.put(req)  # stays pending; retried next cycle
            return None
        tok = self._run("prefill_paged", prompt, slot, self._blocks.allocate(slot, needed),
                        _sampling(req.params))
        # publish the prompt's full blocks for later prefix hits, unless no
        # hit of this size could pay (a longer prompt shares <= max_hit tokens)
        if max_hit >= min_hit:
            self._blocks.register_blocks(slot, prompt, self._blocks.owned_for(slot),
                                         skip_blocks=0)
        return int(tok[0])

    def _prefix_min_hit_tokens(self) -> int:
        """Cached-token floor below which a prefix hit is skipped:
        PREFIX_MIN_HIT_TOKENS when > 0, else auto, the hit must save one
        dispatch round trip of prefill compute (hit x per-token prefill >=
        host round trip). Unmeasured timings keep the cache on."""
        fixed = llm_config.PREFIX_MIN_HIT_TOKENS
        if fixed > 0:
            return fixed
        rt, per_tok = self._host_rt_s, self._prefill_per_tok_s
        if rt <= 0 or per_tok <= 0:
            return 0
        return int(rt / per_tok)

    def _prefill_with_prefix(self, req: _Request, slot: int, prompt: List[int],
                             cached_ids: List[int]) -> Optional[int]:
        """Prefill the suffix over the cached blocks' KV and install it into
        new blocks; the slot's table holds the cached ids, then the new."""
        c = self.config
        bs, n = c.kv_block_size, len(prompt)
        cached_tokens = len(cached_ids) * bs
        suffix = prompt[cached_tokens:]
        s_pad = next(b for b in c.buckets() if b >= len(suffix))
        needed_new = self._blocks.blocks_needed(max(n + 1 - cached_tokens, s_pad))
        total = len(cached_ids) + needed_new
        if total > self._blocks.max_fit(slot):
            self._blocks.release(slot)  # undo the attached prefix refs
            self._fail_request(req, "length")
            return None
        if not self._blocks.can_allocate_for(slot, needed_new):
            self._blocks.release(slot)
            self._waiting.put(req)
            return None
        new_ids = self._blocks.allocate(slot, needed_new)
        tok = self._run("prefill_prefix", suffix, n, slot, cached_ids, new_ids,
                        _sampling(req.params))
        self._blocks.register_blocks(slot, prompt, cached_ids + new_ids,
                                     skip_blocks=len(cached_ids))
        self._blocks.add_hit_tokens(slot, cached_tokens)  # counted only on success
        return int(tok[0])

    def _grow_or_preempt(self, headroom: int = 1, steps=None) -> None:
        """Before a decode burst: every active slot whose writes in the burst
        cross into an unallocated block gets one; when the pool is dry, the
        YOUNGEST request is preempted (its blocks freed, the request queued
        again and later prefilled from its token history). The tables stay
        frozen during a fused burst, so headroom = K reserves its room;
        `steps` (the per-slot plan of _burst_plan) caps each slot's
        reservation at the steps it will take."""
        bs = self.config.kv_block_size
        for slot in list(self._active):
            req = self._active[slot]
            if req is None:
                continue
            # host mirror of state.lengths: prompt + generated - 1 is the
            # next write position
            next_write = len(req.prompt_ids) + req.generated - 1
            slot_headroom = min(headroom, int(steps[slot])) if steps is not None else headroom
            # capped at the table width; re-checked each round, since this
            # request may itself have been preempted
            target = min(next_write + slot_headroom, self.config.max_model_len)
            while (self._active[slot] is req
                   and target - 1 >= self._blocks.slot_capacity(slot)):
                if self._blocks.num_free_for(slot) > 0:
                    (bid,) = self._blocks.allocate(slot, 1)
                    index = self._blocks.slot_capacity(slot) // bs - 1
                    self._run("append_block", slot, index, bid)
                    continue
                # the youngest request of this slot's pool: another
                # replica's blocks would not help it
                victim = max((r for r in self._active.values()
                              if r is not None and self._blocks.same_pool(r.slot, slot)),
                             key=lambda r: r.admitted_at)
                self._preempt(victim)
                if victim is req:
                    break  # this slot's request was the victim

    def _preempt(self, req: _Request) -> None:
        self.num_preemptions += 1
        self._blocks.release(req.slot)
        self._active[req.slot] = None
        req.slot = -1
        with self._lock:
            self.num_active -= 1
            self.num_pending += 1
        self._waiting.put(req)

    def _emit(self, req: _Request, tok: int) -> None:
        req.generated += 1
        req.token_history.append(tok)
        with self._lock:
            self.total_generated += 1
            self._replica_tokens[slot_replica(req.slot, self._slots_per)[0]] += 1
        stops = req.params.stop_token_ids or [self.tokenizer.eos_token_id]
        finished, reason = False, None
        if tok in stops:
            finished, reason = True, "stop"
        elif req.generated >= req.params.max_tokens:
            finished, reason = True, "length"
        emit_ids = [] if reason == "stop" else [tok]
        req.out_queue.put(RequestOutput(
            request_id=req.id, token_ids=emit_ids,
            text=self.tokenizer.decode(emit_ids) if emit_ids else "",
            finished=finished, finish_reason=reason,
            num_prompt_tokens=len(req.prompt_ids), num_generated_tokens=req.generated))
        if finished:
            self._release(req)

    def _release(self, req: _Request) -> None:
        if req.slot >= 0:
            if self._blocks is not None:
                self._blocks.release(req.slot)
            self._active[req.slot] = None
            req.slot = -1
            with self._lock:
                self.num_active -= 1
                self._requests.pop(req.id, None)
                self._aborted.discard(req.id)

    # -- speculative decoding (ray_tpu/llm/engine.py:1462-1684) ---------------------
    def _propose_ngram(self, req: _Request, k: int) -> List[int]:
        """Prompt-lookup drafts (reference vLLM ngram speculator): find the
        most recent earlier occurrence of the trailing n-gram (longest n
        first) and propose the tokens that followed it."""
        ctx = req.token_history  # prompt + every generated token
        if len(ctx) < 2:
            return []
        arr = np.asarray(ctx, dtype=np.int64)
        total = len(arr)
        for n in range(min(self.config.ngram_prompt_lookup_max, total - 1), 0, -1):
            tail = arr[-n:]
            # shifted-equality scan over the whole history, the tail's own
            # occurrence excluded
            m = np.ones(total - n, dtype=bool)
            for j in range(n):
                m &= arr[j:total - n + j] == tail[j]
            hits = np.flatnonzero(m)
            if hits.size:
                start = int(hits[-1])
                cont = ctx[start + n:start + n + k]
                if cont:
                    return cont
        return []

    def _spec_burst_width(self) -> int:
        """Fused-spec burst cap: each window may emit up to k+1 tokens, so the
        per-slot room and budget divide by the window length. Windows accept
        a variable count, so (unlike plain fused decode) the burst width stays
        capped by the tightest slot."""
        c = self.config
        m = self.decode_steps_target()
        if m == 1:
            return 1
        wlen = c.num_speculative_tokens + 1
        for req in self._active.values():
            if req is None:
                continue
            next_write = len(req.prompt_ids) + req.generated - 1
            kv_room = (c.max_model_len - 1) - next_write
            budget = req.params.max_tokens - req.generated
            m = min(m, max(1, min(kv_room, budget) // wlen))
        return _pow2_floor(m)

    def _step_decode_spec_fused(self, m: int) -> None:
        """m speculative windows fused per host sync: the n-gram proposal runs
        ON THE DEVICE against a per-slot history buffer, so the windows chain
        without host round trips (model_runner.spec_multi)."""
        c = self.config
        k = c.num_speculative_tokens
        active_mask = np.array([r is not None for r in self._active.values()], bool)
        if not active_mask.any():
            return
        # history width bucketed to a power of two (at most max_model_len):
        # bounds the upload when contexts are short, as in the JAX engine
        max_ctx = max(len(r.token_history) for r in self._active.values() if r is not None)
        width = min(c.max_model_len, 1 << (max_ctx + m * (k + 1) - 1).bit_length())
        hist = np.zeros((c.max_num_seqs, width), np.int64)
        hlen = np.zeros((c.max_num_seqs,), np.int64)
        for slot, req in self._active.items():
            if req is not None:
                hist[slot, :len(req.token_history)] = req.token_history
                hlen[slot] = len(req.token_history)
        t0 = time.perf_counter()
        toks_m, acc_m, drafted_m = self._run(
            "spec_multi", hist, hlen, active_mask, self._temp, self._top_p, self._top_k, m, k,
            c.ngram_prompt_lookup_max)
        # the one fetch of the burst
        toks_m, acc_m, drafted_m = (t.cpu().numpy() for t in (toks_m, acc_m, drafted_m))
        # keeps the auto-K probe live in fused-spec mode (per-window cost)
        self._note_burst_device_wall(m, time.perf_counter() - t0)
        burst_reqs = {s: r for s, r in self._active.items() if r is not None}
        for step in range(m):
            for slot, req in burst_reqs.items():
                self._emit_spec_window(slot, req, toks_m[step, slot], int(acc_m[step, slot]),
                                       int(drafted_m[step, slot]))

    def _emit_spec_window(self, slot: int, req: _Request, toks_row, acc: int,
                          drafted: int) -> None:
        """Emit one verify window's accepted prefix + bonus token for a slot
        (shared by the single-window and fused paths): counts acceptance,
        discards tokens past a mid-burst finish, finishes at the KV cap."""
        if self._active.get(slot) is not req:
            return  # finished (or aborted) earlier in this burst: tail discarded
        if self._aborted and self._finish_abort(req):
            return  # cancelled mid-burst: tail discarded, blocks freed now
        c = self.config
        self.num_spec_drafted += drafted
        self.num_spec_accepted += min(acc, drafted)
        for t in range(acc + 1):
            if self._active.get(slot) is not req:
                break
            tok = int(toks_row[t])
            self._last_tokens[slot] = tok
            self._emit(req, tok)
            r2 = self._active.get(slot)
            # host mirror of state.lengths (prompt + generated - 1)
            if r2 is not None and (len(r2.prompt_ids) + r2.generated - 1
                                   >= c.max_model_len - 1):
                r2.out_queue.put(RequestOutput(
                    request_id=r2.id, token_ids=[], finished=True, finish_reason="length",
                    num_prompt_tokens=len(r2.prompt_ids), num_generated_tokens=r2.generated))
                self._release(r2)

    def _step_decode_spec(self) -> None:
        """Speculative decode step: the host proposes drafts by n-gram lookup,
        ONE verify forward scores the whole window, and the accepted prefix +
        bonus token all emit this step (greedy slots only; the others ride
        along with no drafts). With a fused burst target > 1, m windows run
        on the device per host sync instead."""
        c = self.config
        k = c.num_speculative_tokens
        if self.decode_steps_target() > 1:
            m = self._spec_burst_width()
            if m > 1 and self._blocks is not None:
                # every window position of the burst must land in an owned block
                self._grow_or_preempt(headroom=m * (k + 1))
                m = min(m, self._spec_burst_width())  # preemption changed the set
            if m > 1:
                self._step_decode_spec_fused(m)
                return
        wlen = k + 1
        if self._blocks is not None:
            self._grow_or_preempt(headroom=wlen)  # every window position owned
        n = c.max_num_seqs
        window = np.zeros((n, wlen), np.int64)
        draft_len = np.zeros((n,), np.int64)
        active_mask = np.zeros((n,), bool)
        for slot, req in self._active.items():
            if req is None:
                continue
            active_mask[slot] = True
            window[slot, 0] = self._last_tokens[slot]
            if self._temp[slot] > 0:
                continue  # greedy accept is exact only at temperature 0
            next_write = len(req.prompt_ids) + req.generated - 1
            room = (c.max_model_len - 1) - next_write - 1
            budget = req.params.max_tokens - req.generated - 1
            cap = max(0, min(k, room, budget))
            drafts = self._propose_ngram(req, cap) if cap else []
            draft_len[slot] = len(drafts)
            window[slot, 1:1 + len(drafts)] = drafts
        if not active_mask.any():
            return  # preemption may have drained every slot
        t0 = time.perf_counter()
        out_toks, n_acc = self._run("spec_verify", window, draft_len, active_mask, self._temp,
                                    self._top_p, self._top_k)
        out_toks, n_acc = out_toks.cpu().numpy(), n_acc.cpu().numpy()  # the one fetch
        # close enough to a decode step to feed the auto-K probe: once it
        # settles, an auto-mode engine graduates to fused bursts
        self._note_burst_device_wall(1, time.perf_counter() - t0)
        burst_reqs = {s: r for s, r in self._active.items() if r is not None}
        for slot, req in burst_reqs.items():
            self._emit_spec_window(slot, req, out_toks[slot], int(n_acc[slot]),
                                   int(draft_len[slot]))

    def _step_decode(self) -> None:
        if self.config.num_speculative_tokens:
            self._step_decode_spec()
            return
        k_steps, steps = self._burst_plan()
        if self._blocks is not None:
            self._grow_or_preempt(headroom=k_steps, steps=steps)
            k_steps, steps = self._burst_plan()  # preemption changed the set
        active_mask = np.array([r is not None for r in self._active.values()], bool)
        if not active_mask.any():
            return  # preemption may have drained every slot
        t0 = time.perf_counter()
        # one decode step, or a fused burst of K decode+sample steps: ONE host sync
        toks_burst = self._run("decode", self._last_tokens, active_mask, k_steps, self._temp,
                               self._top_p, self._top_k, steps).cpu().numpy()  # [K, slots]
        self._note_burst_device_wall(k_steps, time.perf_counter() - t0)
        burst_reqs = {slot: req for slot, req in self._active.items() if req is not None}
        for t in range(toks_burst.shape[0]):
            for slot, req in burst_reqs.items():
                if t >= steps[slot]:
                    continue  # this slot's own budget ended before the burst did
                if self._active.get(slot) is not req:
                    continue  # finished (or aborted) earlier in this burst
                if self._aborted and self._finish_abort(req):
                    continue  # cancelled mid-burst: tail discarded
                tok = int(toks_burst[t, slot])
                self._last_tokens[slot] = tok
                self._emit(req, tok)
                r2 = self._active[slot]
                # host mirror of state.lengths (prompt + generated - 1): a slot
                # whose KV is full finishes here, without a second device fetch
                if r2 is not None and (len(r2.prompt_ids) + r2.generated - 1
                                       >= self.config.max_model_len - 1):
                    r2.out_queue.put(RequestOutput(
                        request_id=r2.id, token_ids=[], finished=True,
                        finish_reason="length", num_prompt_tokens=len(r2.prompt_ids),
                        num_generated_tokens=r2.generated))
                    self._release(r2)

    def _loop(self) -> None:
        while not self._shutdown:
            try:
                # liveness for LLMServer.check_health: a wedged device call
                # shows as a stale tick while requests wait
                self._last_tick_monotonic = time.monotonic()
                self._admit()
                self._process_aborts()
                if any(r is not None for r in self._active.values()):
                    self._step_decode()
                else:
                    self._wakeup.wait(timeout=ENGINE_IDLE_WAIT_S)
                    self._wakeup.clear()
                    if (self._followers is not None and self._tp_error is None
                            and time.monotonic() - self._last_run > PING_S):
                        self._run("ping")
            except Exception:  # the loop must survive: fail in-flight requests
                LOGGER.exception("llm engine loop failed")
                if self._admitting is not None:
                    self._admitting.out_queue.put(RequestOutput(
                        request_id=self._admitting.id, token_ids=[], finished=True,
                        finish_reason="error"))
                    with self._lock:
                        self.num_pending -= 1  # it left _waiting, never admitted
                        self._requests.pop(self._admitting.id, None)
                        self._aborted.discard(self._admitting.id)
                    self._admitting = None
                for req in list(self._active.values()):
                    if req is not None:
                        req.out_queue.put(RequestOutput(
                            request_id=req.id, token_ids=[], finished=True,
                            finish_reason="error"))
                        self._release(req)
                if self._blocks is not None:  # blocks a failed admission held
                    for slot in self._active:
                        self._blocks.release(slot)
                while True:
                    try:
                        req = self._waiting.get_nowait()
                    except queue.Empty:
                        break
                    self._fail_request(req, "error")
                time.sleep(0.1)
