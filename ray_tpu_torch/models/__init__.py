"""Model configs, the Llama-family transformer and the JAX weight bridge."""
from .config import ModelConfig, get_config, register_config

__all__ = ["ModelConfig", "get_config", "register_config"]
