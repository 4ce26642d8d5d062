"""Batch LLM inference over datasets (port of ray_tpu/llm/batch.py).

``Processor`` is a chain of stages applied to a dataset: chat template,
tokenize, engine, detokenize, an HTTP stage against a running OpenAI server
and an image stage for vision models. Any dataset with ``map`` and
``map_batches`` (the latter taking a callable or a class with
``fn_constructor_args``, ``batch_size`` and ``concurrency``) will do. The
engine stage is a stateful UDF holding a ``TorchLLMEngine``, so the model
loads once per instance and each batch rides the continuous batcher.
"""
from __future__ import annotations

import base64
import concurrent.futures
import io
import json
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .config import LLMConfig, SamplingParams
from .engine import TorchLLMEngine
from .server import render_chat_template
from .tokenizer import get_tokenizer


class ChatTemplateStage:
    """messages -> prompt string (reference chat_template_stage.py)."""

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        prompts = [render_chat_template(m) for m in batch["messages"]]
        out = dict(batch)
        out["prompt"] = np.array(prompts, dtype=object)
        return out


class TokenizeStage:
    """prompt -> input token ids (reference tokenize_stage.py). Stateful actor
    UDF so the tokenizer loads once per actor."""

    def __init__(self, tokenizer_spec: str):
        self.tokenizer = get_tokenizer(tokenizer_spec)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        ids = [self.tokenizer.encode(str(p)) for p in batch["prompt"]]
        # np.array(list, dtype=object) silently coerces equal-length lists to 2-D,
        # which would emit fixed_size_list arrow columns that can't concat with
        # ragged batches — fill an object array per element instead
        col = np.empty(len(ids), dtype=object)
        for i, t in enumerate(ids):
            col[i] = np.asarray(t, np.int32)
        out["tokenized_prompt"] = col
        out["num_prompt_tokens"] = np.array([len(i) for i in ids], np.int64)
        return out


class DetokenizeStage:
    """generated token ids -> text (reference detokenize_stage.py)."""

    def __init__(self, tokenizer_spec: str):
        self.tokenizer = get_tokenizer(tokenizer_spec)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        out["generated_text"] = np.array(
            [self.tokenizer.decode(list(ids)) for ids in batch["generated_tokens"]],
            dtype=object,
        )
        return out


class HttpRequestStage:
    """POST each row to an OpenAI-compatible endpoint (reference
    http_request_stage.py): batch inference against a running server (e.g.
    an app from build_openai_app) instead of an in-process engine."""

    def __init__(self, url: str, *, model: str = "", sampling_params: Optional[Dict[str, Any]] = None,
                 headers: Optional[Dict[str, str]] = None, timeout_s: float = 120.0,
                 concurrency: int = 8, max_retries: int = 2):
        self.url = url
        self.model = model
        self.sampling_params = dict(sampling_params or {})
        self.headers = {"Content-Type": "application/json", **(headers or {})}
        self.timeout_s = timeout_s
        self.concurrency = max(1, concurrency)
        self.max_retries = max_retries

    def _post(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        for attempt in range(self.max_retries + 1):
            try:
                req = urllib.request.Request(
                    self.url, data=json.dumps(payload).encode(), headers=self.headers)
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    return json.loads(resp.read())
            except (urllib.error.URLError, OSError):
                if attempt == self.max_retries:
                    raise
                time.sleep(0.5 * 2**attempt)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        def one(prompt) -> str:
            payload = {"model": self.model, "prompt": str(prompt), **self.sampling_params}
            resp = self._post(payload)
            choice = resp["choices"][0]
            return choice.get("text") or choice.get("message", {}).get("content", "")

        # I/O-bound: the serving side batches concurrent requests, so fan out
        with concurrent.futures.ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            texts = list(pool.map(one, batch["prompt"]))
        out = dict(batch)
        out["generated_text"] = np.array(texts, dtype=object)
        return out


class PrepareImageStage:
    """Resolve image references into fixed-size pixel tensors for a VLM engine
    (reference batch/stages/prepare_image_stage.py — ImageProcessor resolving
    http/data-URI/PIL/ndarray image refs out of chat messages).

    Sources handled, per row: an ``image`` column (ndarray / raw encoded bytes
    / file path / data URI), or OpenAI-vision ``messages`` content parts
    ({"type": "image_url", "image_url": {"url": ...}}). Every image lands as a
    float32 [H, W, 3] tensor in [0, 1] at a fixed ``size``: static shapes for
    the downstream engine stage (unlike the reference's variable-size PIL
    passthrough)."""

    def __init__(self, size=(224, 224), mode: str = "RGB"):
        self.size = tuple(size)
        self.mode = mode

    def _decode(self, ref) -> np.ndarray:
        from PIL import Image  # optional: only this stage needs it

        if isinstance(ref, np.ndarray) and ref.ndim >= 2:
            a = ref
            if a.dtype.kind == "f":
                # scale-aware: [0,1] floats (this stage's own output format)
                # must not truncate to all-black via a blind uint8 cast
                a = a * 255.0 if float(a.max(initial=0.0)) <= 1.0 else a
            img = Image.fromarray(np.clip(a, 0, 255).astype(np.uint8))
        elif isinstance(ref, (bytes, bytearray)):
            img = Image.open(io.BytesIO(ref))
        elif isinstance(ref, str) and ref.startswith("data:"):
            b64 = ref.split(",", 1)[1]
            img = Image.open(io.BytesIO(base64.b64decode(b64)))
        elif isinstance(ref, str) and ref.startswith(("http://", "https://")):
            with urllib.request.urlopen(ref, timeout=30) as r:
                img = Image.open(io.BytesIO(r.read()))
        elif isinstance(ref, str):
            img = Image.open(ref)
        else:
            raise TypeError(f"unsupported image reference {type(ref)!r}")
        img = img.convert(self.mode).resize((self.size[1], self.size[0]))
        return np.asarray(img, np.float32) / 255.0

    @staticmethod
    def _refs_from_messages(messages) -> List[Any]:
        refs = []
        for m in messages:
            content = m.get("content")
            if not isinstance(content, (list, tuple)):
                continue
            for part in content:
                if isinstance(part, dict) and part.get("type") == "image_url":
                    url = part.get("image_url")
                    refs.append(url.get("url") if isinstance(url, dict) else url)
        return refs

    @staticmethod
    def to_tensor(images, size=(224, 224)) -> np.ndarray:
        """Re-materialize one row's ``images`` value as a dense
        [n, H, W, 3] float32 tensor — after a block boundary the column
        round-trips as nested lists (and empty rows as shape (0,))."""
        return np.asarray(images, np.float32).reshape(-1, *size, 3)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        n = len(next(iter(batch.values())))
        col = np.empty(n, dtype=object)
        counts = np.zeros(n, np.int64)
        for i in range(n):
            refs: List[Any] = []
            if "image" in batch:
                refs.append(batch["image"][i])
            if "messages" in batch:
                refs.extend(self._refs_from_messages(batch["messages"][i]))
            pixels = [self._decode(r) for r in refs]
            # NOTE a block boundary stores this ragged tensor column as nested
            # lists; consumers re-materialize with to_tensor() (zero-image rows
            # round-trip as shape (0,), hence the reshape there)
            col[i] = (np.stack(pixels) if pixels
                      else np.zeros((0, *self.size, 3), np.float32))
            counts[i] = len(pixels)
        out = dict(batch)
        out["images"] = col
        out["num_images"] = counts
        return out


class LLMEngineStage:
    """Stateful UDF running generation (reference vllm_engine_stage.py) on a
    TorchLLMEngine on `device` (default CUDA), or on `devices` (one per
    rank) under tensor parallelism."""

    def __init__(self, llm_config: LLMConfig, sampling_params: Optional[Dict[str, Any]] = None,
                 device=None, devices=None):
        self.engine = TorchLLMEngine(llm_config, device=device, devices=devices)
        self.engine.start()
        self.params = SamplingParams(**(sampling_params or {}))

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        prompts = list(batch["prompt"])
        if not prompts:  # an upstream filter can empty a block
            out = dict(batch)
            out["generated_text"] = np.array([], dtype=object)
            out["num_generated_tokens"] = np.array([], np.int64)
            return out

        # Feed prompts concurrently so the continuous batcher fills its slots,
        # but bound the fan-out: the engine admits at burst boundaries, so 2x
        # the slot count keeps every freed slot instantly refillable while a
        # 10k-row block doesn't spawn 10k parked threads.
        workers = min(len(prompts),
                      max(1, 2 * self.engine.config.max_num_seqs))
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(
                lambda p: self.engine.generate_sync(str(p), self.params),
                prompts))
        out = dict(batch)
        out["generated_text"] = np.array([r.text for r in results], dtype=object)
        out["num_generated_tokens"] = np.array(
            [r.num_generated_tokens for r in results], np.int64
        )
        return out


class Processor:
    """A configured chain of stages over a Dataset (reference base.py:107)."""

    def __init__(self, stages: List[Any]):
        self.stages = stages

    def __call__(self, dataset):
        for stage in self.stages:
            dataset = stage(dataset)
        return dataset


def build_llm_processor(
    llm_config: LLMConfig,
    *,
    sampling_params: Optional[Dict[str, Any]] = None,
    preprocess: Optional[Callable] = None,
    postprocess: Optional[Callable] = None,
    batch_size: int = 16,
    concurrency: int = 1,
    has_messages: bool = False,
    prepare_images: bool = False,
    image_size=(224, 224),
    device=None,
    devices=None,
) -> Processor:
    """Build the standard chat->generate processor (reference build_llm_processor).
    prepare_images=True inserts the VLM image stage (pixel tensors resolved
    from image refs / vision messages) ahead of generation. `device` and
    `devices` pass to every LLMEngineStage."""

    stages: List[Any] = []
    if preprocess is not None:
        stages.append(lambda ds: ds.map(preprocess))
    if prepare_images:
        stages.append(lambda ds: ds.map_batches(
            PrepareImageStage(size=image_size), batch_size=batch_size))
    if has_messages:
        stages.append(lambda ds: ds.map_batches(ChatTemplateStage(), batch_size=batch_size))
    stages.append(
        lambda ds: ds.map_batches(
            LLMEngineStage,
            fn_constructor_args=(llm_config, sampling_params, device, devices),
            batch_size=batch_size,
            concurrency=concurrency,
        )
    )
    if postprocess is not None:
        stages.append(lambda ds: ds.map(postprocess))
    return Processor(stages)
