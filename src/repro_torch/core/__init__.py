"""Balanced-GEMM planning: hardware specs, the analytical model, the
exhaustive solver, the plan cache and the dispatching ``balanced_gemm``."""
