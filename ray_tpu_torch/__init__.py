"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute stack.

A package of its own beside ``ray_tpu``: it imports ``torch``, numpy and the
standard library, never JAX and never ``ray_tpu``. Module names follow the JAX
package so each counterpart is easy to find (``models/llama.py`` ports
``ray_tpu/models/llama.py``, ``llm/engine.py`` ports ``ray_tpu/llm/engine.py``).
Every Pallas kernel on a ported path becomes a hand-written Hopper kernel under
``ops/csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
Importing this package imports nothing heavy and builds no kernel.
"""
