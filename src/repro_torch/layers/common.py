"""Shared layer utilities (port of ``repro.layers.common``): parameter
init, the ``dense()`` GEMM wrapper, norms, rotary embeddings.

Every matmul routes through :func:`dense`, which calls
``repro_torch.core.gemm.balanced_gemm``: the planned hand-written kernels on
a CUDA tensor, their plain versions on a CPU tensor. Only the float path is
ported; int8 weights are a later item (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.context import current_context
from repro_torch.core.gemm import balanced_gemm


def dense(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    activation: str | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """x @ w (+bias, +activation) through the balanced-GEMM substrate.

    ``w`` is a float (K, N) weight. A bf16 ``x`` times an f32 ``w`` is
    promoted to f32 inside the GEMM, as the reference's ``dot_general``
    does; the result is cast to ``out_dtype`` (default ``x.dtype``).
    """
    if current_context().quant_mode is not None:
        raise NotImplementedError("int8 dense is ROADMAP queue 1, item 6")
    return balanced_gemm(x, w, bias, out_dtype=out_dtype or x.dtype,
                         activation=activation)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-device embedding lookup: rows of ``table`` at ``ids``."""
    return table[ids]


# ------------------------------------------------------------------ init
def normal_init(gen: torch.Generator | None, shape, dtype: torch.dtype,
                scale: float | None = None, *, lead=(),
                device: torch.device | str) -> torch.Tensor:
    """``scale * N(0, 1)`` of shape ``lead + shape`` on ``device``, drawn
    from ``gen`` (a generator of that device); ``scale`` defaults to
    1/sqrt(fan_in) of ``shape``. ``lead`` stacks layers in one draw. On the
    meta device only shapes and dtypes exist (the plan warm-up)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(1, fan_in))
    full = (*lead, *shape)
    if torch.device(device).type == "meta":
        return torch.empty(full, dtype=dtype, device="meta")
    x = torch.randn(full, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


# ------------------------------------------------------------------ rotary
def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10000.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sin, cos) of shape (..., head_dim/2)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, head_dim/2)."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    s = sin[..., None, :]  # broadcast over heads
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(dt)
