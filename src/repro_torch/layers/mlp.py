"""MLP variants (port of ``repro.layers.mlp``): SwiGLU, GELU, squared-ReLU,
with optional biases. The activation rides the fat GEMM kernel's epilogue."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.layers import common as cm


class MlpParams(NamedTuple):
    w_in: torch.Tensor                 # (d, f)
    w_gate: torch.Tensor | None        # (d, f) for gated (SwiGLU) variants
    w_out: torch.Tensor                # (f, d)
    b_in: torch.Tensor | None
    b_out: torch.Tensor | None


def init_mlp(gen, d_model, d_ff, *, gated=True, bias=False,
             dtype=torch.float32, lead=(), device) -> MlpParams:
    """``lead`` prepends stacking dims (the layer axis) to every leaf."""
    w = lambda shape: cm.normal_init(gen, shape, dtype, lead=lead,
                                     device=device)
    zeros = lambda n: torch.zeros((*lead, n), dtype=dtype, device=device)
    return MlpParams(
        w_in=w((d_model, d_ff)),
        w_gate=w((d_model, d_ff)) if gated else None,
        w_out=w((d_ff, d_model)),
        b_in=zeros(d_ff) if bias else None,
        b_out=zeros(d_model) if bias else None,
    )


def mlp(p: MlpParams, x: torch.Tensor, *, activation: str = "silu"
        ) -> torch.Tensor:
    """activation: 'silu' (gated => SwiGLU), 'gelu', 'relu2', 'relu'."""
    if p.w_gate is not None:
        g = cm.dense(x, p.w_gate, activation=activation)
        h = cm.dense(x, p.w_in, p.b_in)
        h = g * h
    else:
        h = cm.dense(x, p.w_in, p.b_in, activation=activation)
    return cm.dense(h, p.w_out, p.b_out)
