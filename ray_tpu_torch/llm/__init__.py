"""LLM serving and batch inference on one CUDA device, or on a tensor-parallel
mesh of ranks (``tp_worker``): engine, model runner, sampling, the server
with its OpenAI and P/D routers, and the batch ``Processor``."""
from .config import LLMConfig, SamplingParams, SpecConfig
from .engine import LLMEngine, RequestOutput, TorchLLMEngine
from .server import (LLMServer, OpenAIRouter, PDRouter, build_openai_app,
                     build_pd_openai_app)
from .batch import (
    ChatTemplateStage,
    DetokenizeStage,
    HttpRequestStage,
    LLMEngineStage,
    PrepareImageStage,
    Processor,
    TokenizeStage,
    build_llm_processor,
)

__all__ = [
    "LLMConfig",
    "SamplingParams",
    "SpecConfig",
    "LLMEngine",
    "TorchLLMEngine",
    "RequestOutput",
    "LLMServer",
    "OpenAIRouter",
    "PDRouter",
    "build_openai_app",
    "build_pd_openai_app",
    "Processor",
    "build_llm_processor",
    "ChatTemplateStage",
    "TokenizeStage",
    "DetokenizeStage",
    "HttpRequestStage",
    "LLMEngineStage",
    "PrepareImageStage",
]
