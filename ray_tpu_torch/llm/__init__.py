"""LLM serving on one CUDA device: engine, model runner, sampling and server."""
from .config import LLMConfig, SamplingParams, SpecConfig
from .engine import LLMEngine, RequestOutput, TorchLLMEngine
from .server import LLMServer

__all__ = ["LLMConfig", "SamplingParams", "SpecConfig", "LLMEngine", "RequestOutput",
           "TorchLLMEngine", "LLMServer"]
