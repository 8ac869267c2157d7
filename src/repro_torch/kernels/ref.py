"""Plain PyTorch versions of the GEMM kernels (counterpart of
``repro.kernels.ref``).

Each ``*_ref`` function defines the semantics a kernel must reproduce at
f32 / i32 accumulation precision. The kernel wrappers run these on CPU
tensors; ``chip_smoke.py`` holds the CUDA kernels against them on the card.

Mixed float inputs promote to f32 before the product, as ``jax.lax.dot_general``
with ``preferred_element_type=f32`` does: a bf16 activation times an f32
weight multiplies the full-f32 weight, never a bf16 rounding of it.
"""
from __future__ import annotations

import torch

_INT_TYPES = (torch.int8, torch.int16, torch.int32)


def is_int(dtype: torch.dtype) -> bool:
    return dtype in _INT_TYPES or dtype in (torch.uint8, torch.int64)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int32 if is_int(dtype) else torch.float32


def saturating_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast from the accumulator type to ``dtype``, saturating for ints."""
    if is_int(dtype):
        info = torch.iinfo(dtype)
        return x.clamp(info.min, info.max).to(dtype)
    return x.to(dtype)


def apply_activation(x: torch.Tensor, name: str | None) -> torch.Tensor:
    if name is None or name == "none":
        return x
    if name == "relu":
        return torch.clamp_min(x, 0)
    if name == "relu2":  # squared ReLU (nemotron-4)
        r = torch.clamp_min(x, 0)
        return r * r
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "silu":
        return torch.nn.functional.silu(x)
    raise ValueError(f"unknown activation {name!r}")


def _product(a: torch.Tensor, b: torch.Tensor, b_layout: str) -> torch.Tensor:
    if b_layout == "col":
        b = b.t()
    elif b_layout != "row":
        raise ValueError(f"b_layout must be 'row' or 'col', got {b_layout!r}")
    if is_int(a.dtype):
        # exact: |sum| < 2**53 for any K an int8 GEMM can have; float64
        # because integer matmul has no CUDA implementation in torch
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    return a.to(torch.float32) @ b.to(torch.float32)


def matmul_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    out_dtype: torch.dtype | None = None,
    b_layout: str = "row",
    bias: torch.Tensor | None = None,
    activation: str | None = None,
    out_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """C = act(A @ B * out_scale + bias), cast to ``out_dtype``.

    ``b_layout='col'`` means ``b`` is stored (N, K). ``out_scale`` (N,) is
    applied to the accumulator before the bias add, which stays in real f32
    units; a scaled result is rounded (half to even) before an integer cast.
    """
    if out_dtype is None:
        out_dtype = a.dtype
    out = _product(a, b, b_layout)
    if out_scale is not None:
        out = out.to(torch.float32) * out_scale.to(torch.float32)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if activation is not None:
        out = apply_activation(out, activation)
    if out_scale is not None and is_int(out_dtype):
        out = torch.round(out)
    return saturating_cast(out, out_dtype)


def split_bf16x3(b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 terms the tensor-core route multiplies in place of an
    f32 B (csrc/matmul.cu, split8): B1 = hi16(B), B2 = hi16(B - B1),
    B3 = B - B1 - B2, by truncation. Each difference is exact in f32 and
    B3 has at most 8 significant bits, so B1 + B2 + B3 == B bit for bit for
    every f32 of magnitude at least 2**-110 (and 0), and A.B1 + A.B2 + A.B3
    is the f32 product A.B up to summation order (a bf16 x bf16 product is
    exact in f32). Below 2**-110 the last bits fall under bf16's smallest
    subnormal, 2**-133, which bounds the error of such an element."""
    hi = lambda x: (x.view(torch.int32) & -65536).view(torch.float32)
    b = b.to(torch.float32).contiguous()
    b1 = hi(b)
    r1 = b - b1
    b2 = hi(r1)
    return b1.bfloat16(), b2.bfloat16(), (r1 - b2).bfloat16()


def gemv_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    out_dtype: torch.dtype | None = None,
    w_layout: str = "row",
) -> torch.Tensor:
    """Decode-time skinny GEMM: (B, K) @ W with small B, no epilogue."""
    return matmul_ref(x, w, out_dtype=out_dtype, b_layout=w_layout)


def gemv_split_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    splits: int,
    k_per_split: int,
    out_dtype: torch.dtype | None = None,
    w_layout: str = "row",
) -> torch.Tensor:
    """The GEMV as its split-K kernel sums it: one f32 (i32) partial per K
    split [s * k_per_split, (s + 1) * k_per_split), added in split order,
    then cast."""
    if out_dtype is None:
        out_dtype = x.dtype
    K = x.shape[1]
    if not (splits - 1) * k_per_split < K <= splits * k_per_split:
        raise ValueError(f"{splits} splits of {k_per_split} do not cover "
                         f"K={K} once")
    total = None
    for s in range(splits):
        k0, k1 = s * k_per_split, min(K, (s + 1) * k_per_split)
        ws = w[:, k0:k1] if w_layout == "col" else w[k0:k1]
        part = _product(x[:, k0:k1], ws, w_layout)
        total = part if total is None else total + part
    return saturating_cast(total, out_dtype)
