"""PyTorch + CUDA port of gcd_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (ops/, models/, diffusion/, engine/, io/,
utils/) and holds the hand-written CUDA kernels under csrc/. Imports torch
and never jax; the JAX package stays the numerical reference.
"""
