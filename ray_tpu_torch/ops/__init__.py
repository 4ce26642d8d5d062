"""Attention ops and the hand-written CUDA kernels (built lazily, never at import)."""
