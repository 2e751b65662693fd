"""PyTorch and CUDA port of the JAX package ``repro``, for NVIDIA Hopper.

Imports torch and numpy, never jax and nothing of ``repro``: what it needs of
the JAX package's jax-free modules it keeps as its own copy.
"""
