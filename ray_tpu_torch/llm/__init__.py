"""LLM serving on one CUDA device: engine, model runner, sampling and server."""
from .config import LLMConfig, SamplingParams
from .engine import LLMEngine, RequestOutput, TorchLLMEngine
from .server import LLMServer

__all__ = ["LLMConfig", "SamplingParams", "LLMEngine", "RequestOutput",
           "TorchLLMEngine", "LLMServer"]
