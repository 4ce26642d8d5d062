"""LLMServer, the OpenAI routers and the serve app builders over
TorchLLMEngine (port of ray_tpu/llm/server.py).

``LLMServer`` hosts one model's engine: OpenAI chat/completions, unary and
SSE, the P/D endpoints (``prefill``, ``decode_from_prefill``,
``decode_stream``), ``metrics`` and ``check_health``. ``OpenAIRouter`` routes
/v1/* to per-model servers; ``PDRouter`` prefills on one pool and decodes on
another. Their handles are whatever the hosting serve runtime gives
(``.options(method_name=..., stream=...).remote(...)``, ``.result()``).

The port imports no serve runtime, so ``build_openai_app`` and
``build_pd_openai_app`` take the hosting serve module as ``serve=`` (its
``deployment`` and ``AutoscalingConfig``) and bind ``device`` into every
LLMServer. The KV crosses from prefill to decode on the host path; a
device-plane handle (``kv_handle``) is ROADMAP A10.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
import uuid
from typing import Any, Dict, List, Optional

from .config import LLMConfig, SamplingParams
from .engine import TorchLLMEngine

_LOGGER = logging.getLogger(__name__)


def _sampling_from_body(body: Dict[str, Any]) -> SamplingParams:
    return SamplingParams(
        max_tokens=int(body.get("max_tokens", 64)),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        seed=body.get("seed"),
    )


def render_chat_template(messages: List[Dict[str, str]]) -> str:
    """Minimal chat template (reference: HF chat templates via vLLM's tokenizer)."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
    return "\n".join(parts) + "\nassistant:"


def _usage(prompt_tokens: int, completion_tokens: int) -> Dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def _chat_envelope(model: str, text: str, finish_reason, usage) -> Dict[str, Any]:
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish_reason,
        }],
        "usage": usage,
    }


def _completion_envelope(model: str, text: str, finish_reason, usage) -> Dict[str, Any]:
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "text": text, "finish_reason": finish_reason}],
        "usage": usage,
    }


def _models_list(model_ids) -> Dict[str, Any]:
    return {
        "object": "list",
        "data": [{"id": m, "object": "model", "owned_by": "ray_tpu"}
                 for m in sorted(model_ids)],
    }


class LLMServer:
    """Hosts one model's engine. ``device`` (default CUDA) and, under tensor
    parallelism, ``devices`` (one per rank) pass through to TorchLLMEngine
    when no engine is given. A decode-pool server gets
    ``prefill_handle``, a handle to the prefill pool, so that decode_stream
    can prefill again over the host path after a device-plane failure."""

    def __init__(self, llm_config: LLMConfig, engine: Optional[TorchLLMEngine] = None,
                 prefill_handle=None, device=None, devices=None):
        self.llm_config = llm_config
        self.engine = engine or TorchLLMEngine(llm_config, device=device, devices=devices)
        self.prefill_handle = prefill_handle
        self.engine.start()

    # -- OpenAI endpoints --------------------------------------------------------
    def chat(self, body: Dict[str, Any]):
        prompt = render_chat_template(body.get("messages", []))
        if body.get("stream"):
            return self._sse_stream(prompt, body, chat=True)
        out = self.engine.generate_sync(prompt, _sampling_from_body(body))
        return _chat_envelope(
            body.get("model", self.llm_config.model_id), out.text, out.finish_reason,
            _usage(out.num_prompt_tokens, out.num_generated_tokens))

    def completions(self, body: Dict[str, Any]):
        if body.get("stream"):
            return self._sse_stream(body.get("prompt", ""), body, chat=False)
        out = self.engine.generate_sync(body.get("prompt", ""), _sampling_from_body(body))
        return _completion_envelope(
            body.get("model", self.llm_config.model_id), out.text, out.finish_reason,
            _usage(out.num_prompt_tokens, out.num_generated_tokens))

    def _sse_stream(self, prompt: str, body: Dict[str, Any], chat: bool):
        """OpenAI ``stream: true``: SSE frames ("data: {chunk}\\n\\n" ...
        "data: [DONE]\\n\\n") as the engine produces tokens."""
        return self._sse_frames(
            lambda rid: self.engine.generate(prompt, _sampling_from_body(body),
                                             request_id=rid),
            body, chat)

    def decode_stream(self, prefill_result, body: Dict[str, Any], chat: bool):
        """The streaming decode side of P/D: continue from a transferred
        prefill and yield SSE frames. A device-plane failure, in the prefill
        result or mid-stream, prefills again over the host path through
        ``prefill_handle`` and resumes the same stream: the tokens already
        yielded are skipped by count, which replays exactly under greedy or
        seeded decoding."""
        sampling = _sampling_from_body(body)
        pre_err: Optional[BaseException] = None
        pre: Optional[Dict[str, Any]] = None
        try:
            pre = _materialize_prefill(prefill_result)
        except Exception as e:
            if self.prefill_handle is None or not _is_device_plane_error(e):
                raise
            pre_err = e

        def host_re_prefill():
            if pre is not None:
                _release_orphan_export(pre)
            prompt = (render_chat_template(body.get("messages", []))
                      if chat else body.get("prompt", ""))
            fb_body = dict(body, _kv_host_fallback=True)
            return self.prefill_handle.options(method_name="prefill").remote(
                prompt, fb_body).result()

        def start_gen(rid):
            yielded = 0
            try:
                if pre_err is not None:
                    raise pre_err
                for out in self.engine.generate_from_prefill(pre, sampling, request_id=rid):
                    yielded += len(out.token_ids)
                    yield out
                return
            except GeneratorExit:
                raise
            except Exception as e:
                if self.prefill_handle is None or not _is_device_plane_error(e):
                    raise
                _LOGGER.warning("device-plane KV handoff failed mid-stream for key %s (%r); "
                                "resuming over the host path", (pre or {}).get("kv_key"), e)
            pre_fb = host_re_prefill()
            skip = yielded
            fb_rid = uuid.uuid4().hex
            try:
                for out in self.engine.generate_from_prefill(pre_fb, sampling,
                                                             request_id=fb_rid):
                    ids = out.token_ids
                    if skip:
                        k = min(skip, len(ids))
                        skip -= k
                        ids = ids[k:]
                        if not ids and not out.finish_reason:
                            continue
                        out = dataclasses.replace(out, token_ids=ids)
                    yield out
            except GeneratorExit:
                self.engine.abort(fb_rid)
                raise

        return self._sse_frames(start_gen, body, chat,
                                presynth=(pre or {}).get("first_text") or "")

    def _sse_frames(self, start_gen, body: Dict[str, Any], chat: bool, presynth: str = ""):
        """SSE frames over start_gen(request_id), an iterator of RequestOutput.
        `presynth` is text already rendered for the first token (P/D's
        first_text), sent before the engine's stream starts."""
        model = body.get("model", self.llm_config.model_id)
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        created = int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"
        tokenizer = self.engine.tokenizer

        def frame(payload: Dict[str, Any]) -> str:
            return f"data: {json.dumps(payload)}\n\n"

        def choices(delta_or_text, finish_reason):
            key = "delta" if chat else "text"
            return [{"index": 0, key: delta_or_text, "finish_reason": finish_reason}]

        def delta_frame(delta_text):
            delta = {"content": delta_text} if chat else delta_text
            return frame({"id": rid, "object": obj, "created": created,
                          "model": model, "choices": choices(delta, None)})

        def gen():
            if chat:
                yield frame({"id": rid, "object": obj, "created": created,
                             "model": model,
                             "choices": choices({"role": "assistant"}, None)})
            finish = None
            # deltas come from re-decoding the FULL id sequence: per-chunk decode
            # splits multi-byte UTF-8 and diverges from the non-streaming text
            all_ids: List[int] = []
            emitted = ""
            if presynth:
                # the first token's text, rendered on the prefill side; the
                # engine replays its id, whose decode lands inside `emitted`
                yield delta_frame(presynth)
                emitted = presynth
            eng_rid = uuid.uuid4().hex
            try:
                for out in start_gen(eng_rid):
                    finish = out.finish_reason
                    all_ids.extend(out.token_ids)
                    full = tokenizer.decode(all_ids)
                    if full.endswith("�"):
                        continue  # mid-codepoint: wait for the next chunk
                    delta_text = full[len(emitted):]
                    emitted = full
                    if delta_text:
                        yield delta_frame(delta_text)
            except GeneratorExit:
                # the client went away: free the engine slot now, not at max_tokens
                self.engine.abort(eng_rid)
                raise
            tail = tokenizer.decode(all_ids)[len(emitted):]
            if tail:
                yield delta_frame(tail)
            yield frame({"id": rid, "object": obj, "created": created, "model": model,
                         "choices": choices({} if chat else "", finish or "stop")})
            yield "data: [DONE]\n\n"

        return gen()

    # -- P/D endpoints ---------------------------------------------------------------
    def prefill(self, prompt: str, body: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.prefill_only(prompt, _sampling_from_body(body),
                                        force_host=bool(body.get("_kv_host_fallback")))

    def release_prefill(self, kv_key: str) -> None:
        """The router's ack that decode pulled the exported KV."""
        self.engine.release_prefill_export(kv_key)

    def decode_from_prefill(self, prefill_result, body: Dict[str, Any]) -> Dict[str, Any]:
        prefill_result = _materialize_prefill(prefill_result)
        ids: List[int] = []
        last = None
        for chunk in self.engine.generate_from_prefill(prefill_result,
                                                       _sampling_from_body(body)):
            ids.extend(chunk.token_ids)
            last = chunk
        return {
            "text": self.engine.tokenizer.decode(ids),
            "token_ids": ids,
            "finish_reason": last.finish_reason,
            "num_prompt_tokens": len(prefill_result["prompt_ids"]),
            "num_generated_tokens": len(ids),
        }

    def model_id(self) -> str:
        return self.llm_config.model_id

    def metrics(self) -> Dict[str, Any]:
        return self.engine.metrics()

    # scheduler-loop stall bound of check_health: far above a slow first step,
    # far below a wedged device
    ENGINE_STALL_S = 300.0

    def check_health(self) -> None:
        eng = self.engine
        if eng._shutdown:
            raise RuntimeError("engine stopped")
        why = eng.health_error()
        if why:
            raise RuntimeError(why)
        # a live loop ticks every burst: requests in flight with a stale tick
        # mean the scheduler thread is wedged, so the replica is replaced
        if eng._loop_thread is not None and (eng.num_active or eng.num_pending):
            stale = time.monotonic() - eng._last_tick_monotonic
            if stale > self.ENGINE_STALL_S:
                raise RuntimeError(
                    f"engine scheduler loop stalled for {stale:.0f}s with "
                    f"{eng.num_active} active / {eng.num_pending} pending requests")

    def shutdown(self) -> None:
        self.engine.shutdown()


class OpenAIRouter:
    """Multi-model ingress: routes /v1/* to per-model LLMServer deployments."""

    def __init__(self, **model_handles):
        self.handles = model_handles  # model_id -> handle to an LLMServer

    def _pick(self, model: Optional[str]):
        if model in self.handles:
            return self.handles[model]
        if model is None and len(self.handles) == 1:
            return next(iter(self.handles.values()))
        raise ValueError(f"unknown model {model!r}; served: {sorted(self.handles)}")

    def handle_http(self, request: Dict[str, Any]):
        path, body = request["path"], request.get("body") or {}
        if path.endswith("/models"):
            return _models_list(self.handles)
        model = body.get("model") if isinstance(body, dict) else None
        handle = self._pick(model)
        stream = bool(isinstance(body, dict) and body.get("stream"))
        if path.endswith("/chat/completions"):
            h = handle.options(method_name="chat", stream=stream)
        elif path.endswith("/completions"):
            h = handle.options(method_name="completions", stream=stream)
        else:
            raise ValueError(f"unsupported path {path!r}")
        resp = h.remote(body)
        # streaming: the response generator itself, re-streamed by the caller
        return resp if stream else resp.result()

    def chat(self, body: Dict[str, Any]):
        return self.handle_http({"path": "/v1/chat/completions", "method": "POST", "body": body})

    def completions(self, body: Dict[str, Any]):
        return self.handle_http({"path": "/v1/completions", "method": "POST", "body": body})


def _materialize_prefill(pre):
    """The prefill result behind a response future the router forwarded,
    so that decode dispatch overlaps the prefill; a prefill failure raises
    here."""
    return pre.result() if hasattr(pre, "result") else pre


def _release_orphan_export(pre: Dict[str, Any]) -> None:
    """Free an orphaned device-plane KV export after a host fallback. A
    host-path result pins nothing; a device-plane handle cannot be released
    here (ROADMAP A10), which leaves it to its exporter's TTL."""
    if pre.get("kv_handle") is None:
        return
    _LOGGER.warning("cannot release prefill KV export %s: the device-plane handoff is "
                    "ROADMAP A10; its exporter's TTL reclaims it", pre.get("kv_key"))


def _is_device_plane_error(e: BaseException) -> bool:
    """A DevicePlaneError, by class name, that may arrive re-raised, wrapped
    or as a cause through an RPC boundary."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if type(cur).__name__ == "DevicePlaneError":
            return True
        cur = cur.__cause__ or cur.__context__
    return "DevicePlaneError" in str(e)


class PDRouter:
    """Prefill/decode-disaggregated ingress: a prompt prefills on one pool,
    its KV crosses to a decode pool that produces the completion.
    ``stream_handoff`` is the hosting serve runtime's StreamHandoff class,
    if it has one: a streamed decode is handed to the HTTP proxy before its
    first frame; without it the frames are relayed through this router."""

    def __init__(self, prefill_handle, decode_handle, model_id: str, stream_handoff=None):
        self.prefill_handle = prefill_handle
        self.decode_handle = decode_handle
        self.model_id = model_id
        self.stream_handoff = stream_handoff

    def _settle_prefill(self, pre_resp, timeout_s: float = 5.0):
        """The prefill result for fallback handling, or None when it cannot
        be had (its producer died with it)."""
        try:
            return pre_resp.result(timeout_s=timeout_s)
        except Exception:
            return None

    def _run(self, prompt: str, body: Dict[str, Any]) -> Dict[str, Any]:
        # the decode call is dispatched at once with the prefill's response
        # future, which the decode server resolves itself
        pre_resp = self.prefill_handle.options(method_name="prefill").remote(prompt, body)
        try:
            return self.decode_handle.options(method_name="decode_from_prefill").remote(
                pre_resp, body).result()
        except Exception as e:
            if not _is_device_plane_error(e):
                # a prefill failure is the request's real fate: surface it
                # rather than the decode-side wrapper it arrived in
                pre_resp.result()
                raise
            pre = self._settle_prefill(pre_resp)
            if pre is not None and "kv_handle" not in pre:
                raise
            _LOGGER.warning("device-plane KV handoff failed for key %s (%r); retrying over "
                            "the host path", (pre or {}).get("kv_key"), e)
            if pre is not None:
                _release_orphan_export(pre)
            body = dict(body, _kv_host_fallback=True)
            pre = self.prefill_handle.options(method_name="prefill").remote(
                prompt, body).result()
            return self.decode_handle.options(method_name="decode_from_prefill").remote(
                pre, body).result()

    def chat(self, body: Dict[str, Any]) -> Dict[str, Any]:
        out = self._run(render_chat_template(body.get("messages", [])), body)
        return _chat_envelope(
            body.get("model", self.model_id), out["text"], out["finish_reason"],
            _usage(out["num_prompt_tokens"], out["num_generated_tokens"]))

    def completions(self, body: Dict[str, Any]) -> Dict[str, Any]:
        out = self._run(body.get("prompt", ""), body)
        return _completion_envelope(
            body.get("model", self.model_id), out["text"], out["finish_reason"],
            _usage(out["num_prompt_tokens"], out["num_generated_tokens"]))

    def handle_http(self, request: Dict[str, Any]):
        path, body = request["path"], request.get("body") or {}
        if path.endswith("/models"):
            return _models_list([self.model_id])
        chat = path.endswith("/chat/completions")
        if not chat and not path.endswith("/completions"):
            raise ValueError(f"unsupported path {path!r}")
        if isinstance(body, dict) and body.get("stream"):
            prompt = (render_chat_template(body.get("messages", []))
                      if chat else body.get("prompt", ""))
            return self._stream_pd(prompt, body, chat)
        return self.chat(body) if chat else self.completions(body)

    def _stream_pd(self, prompt: str, body: Dict[str, Any], chat: bool):
        """Streaming P/D: dispatch the prefill, then hand the decode server's
        SSE stream (which owns every fallback) to the proxy before its first
        frame, or relay its frames."""
        pre_resp = self.prefill_handle.options(method_name="prefill").remote(prompt, body)

        def gen():
            resp = self.decode_handle.options(method_name="decode_stream", stream=True).remote(
                pre_resp, body, chat)
            ho = self.stream_handoff.of(resp) if self.stream_handoff is not None else None
            if ho is not None:
                yield ho
                return
            # a response that is not itself iterable (a local-testing handle's)
            # holds the generator as its result
            yield from (resp if hasattr(resp, "__iter__") else resp.result())

        return gen()


def _stream_handoff_of(serve):
    """The hosting serve module's StreamHandoff class, or None."""
    return getattr(getattr(serve, "handle", None), "StreamHandoff", None)


def build_pd_openai_app(llm_config: LLMConfig, *, serve, device=None, num_prefill: int = 1,
                        num_decode: int = 1, name_prefix: str = "llm-pd",
                        max_prefill: Optional[int] = None, max_decode: Optional[int] = None,
                        ttft_slo_name: Optional[str] = None, prefill_autoscaling=None,
                        decode_autoscaling=None):
    """Prefill/decode-disaggregated serving app on the hosting `serve`
    module, with `device` bound into every LLMServer.

    Each pool autoscales on its own signal: the prefill pool on TTFT-SLO
    burn (pinned to ``ttft_slo_name`` when given), the decode pool on queue
    depth, each engaged when ``max_prefill`` / ``max_decode`` exceed the
    ``num_*`` floors; ``prefill_autoscaling`` / ``decode_autoscaling``
    (``serve.AutoscalingConfig``) override either. Without caps the pools
    stay at ``num_prefill`` / ``num_decode``."""
    scaling = serve.AutoscalingConfig
    if prefill_autoscaling is None and (max_prefill or 0) > num_prefill:
        prefill_autoscaling = scaling.for_slo(
            min_replicas=num_prefill, max_replicas=max_prefill,
            slo_names=[ttft_slo_name] if ttft_slo_name else None)
    if decode_autoscaling is None and (max_decode or 0) > num_decode:
        decode_autoscaling = scaling.for_slo(min_replicas=num_decode, max_replicas=max_decode)

    prefill = serve.deployment(LLMServer).options(
        name=f"{name_prefix}:prefill", num_replicas=num_prefill, max_ongoing_requests=32,
        autoscaling_config=prefill_autoscaling).bind(llm_config, device=device)
    decode = serve.deployment(LLMServer).options(
        name=f"{name_prefix}:decode", num_replicas=num_decode, max_ongoing_requests=64,
        autoscaling_config=decode_autoscaling).bind(llm_config, prefill_handle=prefill,
                                                    device=device)
    router = serve.deployment(PDRouter).options(name=f"{name_prefix}-router")
    return router.bind(prefill, decode, llm_config.model_id,
                       stream_handoff=_stream_handoff_of(serve))


def build_openai_app(llm_configs: List[LLMConfig], name_prefix: str = "llm", *, serve,
                     device=None, devices=None):
    """An OpenAIRouter ingress over one LLMServer deployment per model, on
    the hosting `serve` module, with `device` (and `devices`, one per
    tensor-parallel rank) bound into every LLMServer.
    Each config's ``deployment_config`` gives its num_replicas,
    max_ongoing_requests and ray_actor_options."""
    servers = {}
    for cfg in llm_configs:
        d = serve.deployment(LLMServer).options(
            name=f"{name_prefix}:{cfg.model_id}",
            num_replicas=cfg.deployment_config.get("num_replicas", 1),
            max_ongoing_requests=cfg.deployment_config.get("max_ongoing_requests", 64),
            ray_actor_options=cfg.deployment_config.get("ray_actor_options"),
        )
        servers[cfg.model_id] = d.bind(cfg, device=device, devices=devices)
    router = serve.deployment(OpenAIRouter).options(name=f"{name_prefix}-router")
    return router.bind(**servers)
