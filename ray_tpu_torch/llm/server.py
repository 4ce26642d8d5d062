"""LLMServer: OpenAI-style chat/completions over TorchLLMEngine
(port of ray_tpu/llm/server.py:23-335).

A plain class hosting one model's engine, non-streaming and SSE. The Serve
deployment wiring, the routers (OpenAIRouter, PDRouter, build_openai_app) and
the P/D endpoints are later slices (ROADMAP A4).
"""
from __future__ import annotations

import json
import time
import uuid
from typing import Any, Dict, List, Optional

from .config import LLMConfig, SamplingParams
from .engine import TorchLLMEngine


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


class LLMServer:
    """Hosts one model's engine behind OpenAI chat/completions. ``device``
    (default CUDA) passes through to TorchLLMEngine when no engine is given."""

    def __init__(self, llm_config: LLMConfig, engine: Optional[TorchLLMEngine] = None,
                 device=None):
        self.llm_config = llm_config
        self.engine = engine or TorchLLMEngine(llm_config, device=device)
        self.engine.start()

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
        model = body.get("model", self.llm_config.model_id)
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        created = int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"
        tokenizer = self.engine.tokenizer
        sampling = _sampling_from_body(body)

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
            eng_rid = uuid.uuid4().hex
            try:
                for out in self.engine.generate(prompt, sampling, request_id=eng_rid):
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

    def shutdown(self) -> None:
        self.engine.shutdown()
