"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py)."""
import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs torch on one thread; the old count comes back after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def init_scale(name: str, cfg) -> float:
    """Per-leaf init scale of ray_tpu/models/llama.py:65-110 (0 = ones)."""
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    return {"attn_norm": 0.0, "mlp_norm": 0.0, "final_norm": 0.0, "embed": 1.0,
            "wo": (2 * n * d) ** -0.5, "w_down": (2 * n * ff) ** -0.5}.get(name, d ** -0.5)


def numpy_params(cfg, seed=0):
    """A numpy tree with the structure and shapes of the JAX llama.init(cfg)
    and its scale rules, drawn from a numpy seed (jax.random would only add
    compile time)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_llama.init(jax.random.PRNGKey(0), cfg))

    def leaf(path, sd):
        scale = init_scale(path[-1].key, cfg)
        if scale == 0.0:
            return np.ones(sd.shape, np.float32)
        return (rng.standard_normal(sd.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
