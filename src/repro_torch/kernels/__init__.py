"""GEMM kernels: hand-written CUDA for sm_90a (``csrc/``), their plain
PyTorch versions (``ref``), and the planning / dispatch wrappers (``ops``)."""
