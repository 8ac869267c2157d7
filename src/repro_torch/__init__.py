"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package imports neither it
nor ``jax``. Every GEMM of the dense LM goes through the balanced-GEMM
planner into one of two hand-written CUDA kernels (``kernels/csrc``) on a
CUDA tensor, or into the kernels' plain PyTorch versions on a CPU tensor.
"""
__version__ = "0.1.0"
