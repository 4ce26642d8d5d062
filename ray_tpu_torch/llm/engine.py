"""LLMEngine ABC + TorchLLMEngine: continuous batching on one CUDA device
(port of ray_tpu/llm/engine.py, slot layout).

A scheduler thread (1) admits waiting requests into free cache slots with a
whole-prompt prefill padded to a bucket, (2) advances every active slot with
one decode step, or a fused K-step decode+sample burst with one host sync, and
(3) streams tokens out through per-request queues. Requests admit, retire and
abort at burst boundaries without draining the batch, and a per-slot step
budget keeps one near-finished request from collapsing the burst width.

Paged KV with the prefix cache, chunked prefill, P/D disaggregation and
speculation (ROADMAP A2), pipeline parallelism (A6) and telemetry (A11) are
later slices.
"""
from __future__ import annotations

import abc
import dataclasses
import logging
import queue
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.config import torch_dtype

from . import model_runner
from .config import (ENGINE_IDLE_WAIT_S, FUSED_STEPS_MAX, FUSED_SYNC_TARGET,
                     LLMConfig, SamplingParams)
from .tokenizer import get_tokenizer

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


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1): burst widths are powers of two."""
    return 1 << (max(1, int(n)).bit_length() - 1)


class _Request:
    def __init__(self, req_id: str, prompt_ids: List[int], params: SamplingParams):
        self.id = req_id
        self.prompt_ids = prompt_ids
        self.params = params
        self.out_queue: "queue.Queue[RequestOutput]" = queue.Queue()
        self.generated = 0
        self.slot = -1


class TorchLLMEngine(LLMEngine):
    """Slot-based continuous batching over model_runner's prefill/decode.

    `params` (a llama parameter dict of tensors) replaces the random init from
    seed 0; either way the weights are stored in ``config.dtype`` at start.
    `device` defaults to CUDA and raises when there is none; pass "cpu" for
    the plain path."""

    def __init__(self, config: LLMConfig, params=None, device=None):
        self.config = config
        self.model_config = config.resolve_model_config()
        self.tokenizer = get_tokenizer(config.tokenizer)
        self.device = resolve_device(device)
        self._params_in = params
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
        self.state: Optional[model_runner.DecodeState] = None
        self._fused_auto = False
        self._fused_fixed = 1
        self._host_rt_s = 0.0  # measured tiny dispatch+fetch round trip
        self._step_s = 0.0  # EWMA of per-decode-step device time
        self._k_seen: set = set()  # burst widths already run (first is warm-up)
        self.num_prefills = 0
        self.total_generated = 0

    # -- lifecycle ---------------------------------------------------------------
    def start(self) -> None:
        """Place the weights on the device in config.dtype (thread-safe,
        idempotent). The KV state and the scheduler loop start on first use."""
        with self._start_lock:
            if self._started:
                return
            cfg, c = self.model_config, self.config
            k_cfg = c.resolve_decode_steps()
            self._fused_auto = k_cfg == 0
            self._fused_fixed = 1 if self._fused_auto else _pow2_floor(k_cfg)
            dtype = torch_dtype(c.dtype)
            if self._params_in is not None:
                self.params = {
                    name: ({k: v.to(self.device, dtype) for k, v in val.items()}
                           if name == "layers" else val.to(self.device, dtype))
                    for name, val in self._params_in.items()}
            else:
                self.params = llama.init(cfg, seed=0, device=self.device, dtype=dtype)
            self._params_in = None
            self._active = {s: None for s in range(c.max_num_seqs)}
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(0)
            n = c.max_num_seqs
            # host mirrors of per-slot sampling params
            self._temp = np.zeros((n,), np.float32)
            self._top_p = np.ones((n,), np.float32)
            self._top_k = np.zeros((n,), np.int64)
            self._last_tokens = np.zeros((n,), np.int64)
            self._started = True

    def _ensure_decode_started(self) -> None:
        """Allocate the decode KV state + scheduler loop on first decode use."""
        with self._start_lock:
            if self._loop_thread is not None:
                return
            c = self.config
            if self.state is None:
                self.state = model_runner.init_state(
                    self.model_config, c.max_num_seqs, c.max_model_len, self.device)
            self._measure_host_rt()
            self._loop_thread = threading.Thread(target=self._loop, daemon=True,
                                                 name="llm-engine")
            self._loop_thread.start()

    def shutdown(self) -> None:
        self._shutdown = True
        self._wakeup.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)

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

    def _pad_to_bucket(self, prompt_ids: List[int]) -> torch.Tensor:
        s_pad = next(b for b in self.config.buckets() if b >= len(prompt_ids))
        tokens = np.zeros((1, s_pad), np.int64)
        tokens[0, : len(prompt_ids)] = prompt_ids
        return torch.from_numpy(tokens).to(self.device)

    # -- API ---------------------------------------------------------------------
    def generate(self, prompt, params: SamplingParams, request_id: Optional[str] = None
                 ) -> Iterator[RequestOutput]:
        self.start()
        self._ensure_decode_started()
        prompt_ids = self._encode_prompt(prompt, params)
        req = _Request(request_id or uuid.uuid4().hex, prompt_ids, params)
        with self._lock:
            self._requests[req.id] = req
        self._waiting.put(req)
        self._wakeup.set()
        while True:
            out = req.out_queue.get()
            yield out
            if out.finished:
                return

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
            self._requests.pop(req.id, None)
            self._aborted.discard(req.id)

    def _admit(self) -> None:
        """Whole-prompt prefill of waiting requests into free slots (the
        slot-layout branch of the JAX engine's ``_admit_inner``)."""
        cfg = self.model_config
        for slot in [s for s, r in self._active.items() if r is None]:
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                was_aborted = req.id in self._aborted
                self._aborted.discard(req.id)
            if was_aborted:
                self._fail_request(req, "abort")
                continue
            # visible to the loop's crash handler: in neither _waiting nor _active
            self._admitting = req
            p = req.params
            tokens = self._pad_to_bucket(req.prompt_ids)
            self.state, last_logits = model_runner.prefill(
                self.params, self.state, tokens, len(req.prompt_ids), slot, cfg)
            self.num_prefills += 1
            tok = self._sample_one(last_logits, p)
            req.slot = slot
            self._active[slot] = req
            self._temp[slot], self._top_p[slot], self._top_k[slot] = (
                p.temperature, p.top_p, p.top_k)
            self._last_tokens[slot] = tok
            self._admitting = None
            self._emit(req, tok)

    def _sample_one(self, last_logits: torch.Tensor, p: SamplingParams) -> int:
        dev = self.device
        return int(model_runner.sample_tokens(
            last_logits[None, :],
            torch.tensor([p.temperature], dtype=torch.float32, device=dev),
            torch.tensor([p.top_p], dtype=torch.float32, device=dev),
            torch.tensor([p.top_k], dtype=torch.int64, device=dev),
            self._gen)[0])

    def _emit(self, req: _Request, tok: int) -> None:
        req.generated += 1
        with self._lock:
            self.total_generated += 1
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
            self._active[req.slot] = None
            req.slot = -1
            with self._lock:
                self._requests.pop(req.id, None)
                self._aborted.discard(req.id)

    def _step_decode(self) -> None:
        cfg, dev = self.model_config, self.device
        k_steps, steps = self._burst_plan()
        active_mask = np.array([r is not None for r in self._active.values()], bool)
        if not active_mask.any():
            return
        t0 = time.perf_counter()
        last = torch.from_numpy(self._last_tokens).to(dev)
        active = torch.from_numpy(active_mask).to(dev)
        temp = torch.from_numpy(self._temp).to(dev)
        top_p = torch.from_numpy(self._top_p).to(dev)
        top_k = torch.from_numpy(self._top_k).to(dev)
        if k_steps > 1:
            # fused burst: K decode+sample steps, ONE host sync
            self.state, toks_k = model_runner.decode_multi(
                self.params, self.state, last, active, cfg, k_steps, temp, top_p,
                top_k, torch.from_numpy(steps).to(dev), self._gen)
            toks_burst = toks_k.cpu().numpy()  # [K, slots] — the only fetch
        else:
            self.state, logits = model_runner.decode_step(
                self.params, self.state, last, active, cfg)
            toks_burst = model_runner.sample_tokens(
                logits, temp, top_p, top_k, self._gen).cpu().numpy()[None, :]
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
                self._admit()
                self._process_aborts()
                if any(r is not None for r in self._active.values()):
                    self._step_decode()
                else:
                    self._wakeup.wait(timeout=ENGINE_IDLE_WAIT_S)
                    self._wakeup.clear()
            except Exception:  # the loop must survive: fail in-flight requests
                LOGGER.exception("llm engine loop failed")
                if self._admitting is not None:
                    self._admitting.out_queue.put(RequestOutput(
                        request_id=self._admitting.id, token_ids=[], finished=True,
                        finish_reason="error"))
                    with self._lock:
                        self._requests.pop(self._admitting.id, None)
                        self._aborted.discard(self._admitting.id)
                    self._admitting = None
                for req in list(self._active.values()):
                    if req is not None:
                        req.out_queue.put(RequestOutput(
                            request_id=req.id, token_ids=[], finished=True,
                            finish_reason="error"))
                        self._release(req)
                while True:
                    try:
                        req = self._waiting.get_nowait()
                    except queue.Empty:
                        break
                    self._fail_request(req, "error")
                time.sleep(0.1)
