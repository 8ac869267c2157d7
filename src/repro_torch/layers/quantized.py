"""W8A8 quantized layer path through the balanced-GEMM substrate (port of
``repro.layers.quantized``).

``QuantizedLinear`` stores weights as int8 in the (N, K) col layout, the
B^T option of the GEMM. Activations are quantized per tensor on the fly
(dynamic W8A8); weights carry per-output-channel scales. The GEMM runs int8
x int8 -> i32 (``csrc/matmul.cu``: ``split_k`` at M <= 32,
``tensor_core_int8`` above) and the per-channel ``out_scale = s_x · s_w[j]``,
the f32 bias and the saturating cast run in its epilogue before the one
output write: no i32 accumulator ever reaches memory.

The activation's scale spans every row of ``x``: pad positions of a
prefill chunk and vacant engine lanes included, as in the reference (so
lanes of one step share one scale). The quantization itself is torch ops
(an absmax reduction, then divide, round, clip and cast), not a kernel of
the port: the reference's is jnp that XLA fuses, not Pallas.

Over a mesh the reference's ``jnp.max`` runs under GSPMD and spans the
whole global tensor: the one-device scale. Here each rank holds a share
of ``x``, so :func:`activation_scale` takes the local absmax and then the
MAX over every mesh axis that splits ``x``'s elements in this call
(``core.distributed.scale_max``, exact in any order): the DP axes where
the step's rows are cut (the sharded plan's ``rows_whole`` false), and
the axes the caller names (``scale_over``: 'model' for a row-parallel
block's K, or attention's 'seq' mode's rows). ``scale_over=None`` keeps
the scale local: the MoE block's router, which the reference computes
inside ``shard_map``, per shard.

Tensor parallelism (``core.distributed.column_parallel`` /
``row_parallel``): a column block's product is :func:`qdense` on this
rank's N block of ``w_q``, ``w_scale`` and the bias, a float weight's
per-channel scale local (its K is whole). :func:`row_parallel` takes a K
block: the int8 product with int32 out and no epilogue, the partials
summed over 'model' (exact), then ``out_scale = s_x · s_w``, the bias, the
activation and the cast (``kernels.ref.epilogue``, the kernel's order),
as XLA runs the reference's dot under GSPMD. A pre-quantized weight's
``w_scale`` is whole there (quantized at load on the whole weight); a
float weight's per-channel absmax takes the MAX over 'model'. Both give
the one-device product's bits.

Two output modes:
* float out (default): ``out_scale`` dequantizes straight to bf16/f32;
* int8 out (``out_qscale=s_out``): ``out_scale = s_x · s_w[j] / s_out``,
  the requantize chain for fully quantized layer stacks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context
from repro_torch.core.gemm import balanced_gemm
from repro_torch.kernels.ref import epilogue
from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers.attention import AttnParams
from repro_torch.layers.mlp import MlpParams
from repro_torch.quant import int8 as qz
from repro_torch.quant.int8 import QuantizedLinear, quantize_linear


def activation_scale(x: torch.Tensor, over=()) -> torch.Tensor:
    """The per-tensor W8A8 scale of ``x`` (0-d f32), over every rank that
    holds a share of it: the mesh axes above 1 of the active sharded plan
    that split ``x``'s elements, the DP axes where the step's rows are cut
    and then ``over``; the one-device scale. ``over=None``: this rank's
    ``x`` alone."""
    plan = current_context().shard
    if plan is None or over is None:
        return qz.absmax_scale(x)
    mesh = plan.mesh
    axes = () if plan.rows_whole else tuple(mesh.dp_axes())
    axes += tuple(a for a in over if a not in axes)
    axes = tuple(a for a in axes if mesh.axis_size(a) > 1)
    if not axes:
        return qz.absmax_scale(x)
    return qz.absmax_scale(
        x, reduce=lambda amax: cd.scale_max(amax, mesh, axes))


def quantize_activation(x: torch.Tensor, over=()
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_q int8, s_x 0-d f32): ``x`` on one per-tensor symmetric grid,
    its scale :func:`activation_scale`'s."""
    s_x = activation_scale(x, over)
    return qz.quantize(x, s_x), s_x


def qdense(
    x: torch.Tensor,
    ql: QuantizedLinear,
    *,
    activation: str | None = None,
    out_dtype: torch.dtype | None = None,
    out_qscale: torch.Tensor | None = None,
    scale_over=(),
) -> torch.Tensor:
    """Quantized dense: per-tensor dynamic activation quant + int8 GEMM.

    Returns float (``out_dtype``, default x.dtype) unless ``out_qscale`` is
    given, in which case the epilogue requantizes to int8 at that scale.
    The epilogue applies ``out_scale`` to the i32 accumulator first and adds
    the bias in real f32 units after. With ``out_qscale`` the output is in
    s_out units, so the bias is pre-divided and only scale-commuting
    activations (relu / none) are legal. ``scale_over``: as
    :func:`activation_scale` takes it.
    """
    out_dtype = out_dtype or x.dtype
    x_q, s_x = quantize_activation(x, scale_over)
    out_scale = qz.combine_scales(s_x, ql.w_scale)  # (N,)
    bias = ql.bias
    if out_qscale is not None:
        if activation not in (None, "none", "relu"):
            raise ValueError(
                f"activation {activation!r} with out_qscale would run in the "
                "requantized domain (act(x/s) != act(x)/s); only 'relu'/none "
                "commute with the output scale")
        out_scale = out_scale / out_qscale
        if bias is not None:
            bias = bias / out_qscale  # keep bias consistent with s_out units
        out_dtype = torch.int8
    return balanced_gemm(
        x_q, ql.w_q, bias, out_dtype=out_dtype, b_layout="col",
        activation=activation, out_scale=out_scale)


def dynamic_qdense(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    activation: str | None = None,
    out_dtype: torch.dtype | None = None,
    scale_over=(),
) -> torch.Tensor:
    """Drop-in int8 replacement for :func:`repro_torch.layers.common.dense`:
    quantizes the (K, N) float weight per channel and the activation per
    tensor at every call (``quant_mode="int8"`` with a float weight). The
    float weight is read at every call and its int8 (N, K) copy written:
    the numerics of W8A8 without its memory win."""
    return qdense(x, quantize_linear(w, bias), activation=activation,
                  out_dtype=out_dtype, scale_over=scale_over)


def w8a8(x: torch.Tensor, w, bias: torch.Tensor | None = None, *,
         activation: str | None = None, out_dtype: torch.dtype | None = None,
         scale_over=()) -> torch.Tensor:
    """``x @ w`` on the W8A8 path: :func:`qdense` for a
    ``QuantizedLinear`` (``bias``, if given, taken in f32), else
    :func:`dynamic_qdense` of the float weight."""
    if isinstance(w, QuantizedLinear):
        if bias is not None:
            w = w._replace(bias=bias.to(torch.float32))
        return qdense(x, w, activation=activation, out_dtype=out_dtype,
                      scale_over=scale_over)
    return dynamic_qdense(x, w, bias, activation=activation,
                          out_dtype=out_dtype, scale_over=scale_over)


def row_parallel(h_block: torch.Tensor, w_block, bias=None, *, mesh,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``h @ W + bias`` whole on every rank of 'model' from this rank's K
    blocks (``h_block``'s columns; ``w_block`` a ``QuantizedLinear`` whose
    ``w_q`` is an (N, K / tp) block and ``w_scale`` whole, or a float (K /
    tp, N) block), on the W8A8 path (the module docstring): the int8
    product with int32 out, summed over 'model', then the epilogue."""
    if isinstance(w_block, QuantizedLinear):
        w_q, w_scale = w_block.w_q, w_block.w_scale
        bias = w_block.bias if bias is None else bias
    else:
        w_scale = qz.absmax_scale(
            w_block, axis=-1,
            reduce=lambda amax: cd.scale_max(amax, mesh, "model"))
        w_q = qz.quantize(w_block, w_scale, axis=-1).transpose(
            -1, -2).contiguous()
    x_q, s_x = quantize_activation(h_block, ("model",))
    acc = balanced_gemm(x_q, w_q, out_dtype=torch.int32, b_layout="col")
    acc = cd.reduce_from_model(acc, mesh)
    return epilogue(acc, out_dtype=out_dtype,
                    bias=None if bias is None else bias.to(torch.float32),
                    out_scale=qz.combine_scales(s_x, w_scale))


# ------------------------------------------------------------------- MLP
class QuantizedMlpParams(NamedTuple):
    w_in: QuantizedLinear
    w_gate: QuantizedLinear | None
    w_out: QuantizedLinear


def quantize_mlp(p: MlpParams) -> QuantizedMlpParams:
    return QuantizedMlpParams(
        w_in=quantize_linear(p.w_in, p.b_in),
        w_gate=None if p.w_gate is None else quantize_linear(p.w_gate),
        w_out=quantize_linear(p.w_out, p.b_out),
    )


def qmlp(qp: QuantizedMlpParams, x: torch.Tensor, *,
         activation: str = "silu") -> torch.Tensor:
    """Quantized mirror of :func:`repro_torch.layers.mlp.mlp`."""
    if qp.w_gate is not None:
        g = qdense(x, qp.w_gate, activation=activation)
        h = qdense(x, qp.w_in)
        h = g * h
    else:
        h = qdense(x, qp.w_in, activation=activation)
    return qdense(h, qp.w_out)


# -------------------------------------------------------------- attention
class QuantizedAttnParams(NamedTuple):
    wq: QuantizedLinear
    wk: QuantizedLinear
    wv: QuantizedLinear
    wo: QuantizedLinear


def quantize_attn(p: AttnParams) -> QuantizedAttnParams:
    return QuantizedAttnParams(
        wq=quantize_linear(p.wq, p.bq),
        wk=quantize_linear(p.wk, p.bk),
        wv=quantize_linear(p.wv, p.bv),
        wo=quantize_linear(p.wo),
    )


def q_self_attention(
    qp: QuantizedAttnParams,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float = 10000.0,
    causal: bool = True,
    chunk: int | None = 1024,
    use_rope: bool = True,
) -> torch.Tensor:
    """GQA self-attention with all four projections through the int8 path;
    scores and softmax stay in float."""
    B, S, _ = x.shape
    q = qdense(x, qp.wq).reshape(B, S, n_heads, head_dim)
    k = qdense(x, qp.wk).reshape(B, S, n_kv_heads, head_dim)
    v = qdense(x, qp.wv).reshape(B, S, n_kv_heads, head_dim)
    if use_rope:
        positions = torch.arange(S, device=x.device)[None, :]
        sin, cos = cm.rotary_embedding(positions, head_dim, rope_theta)
        q = cm.apply_rotary(q, sin, cos)
        k = cm.apply_rotary(k, sin, cos)
    k = attn._repeat_kv(k, n_heads // n_kv_heads)
    v = attn._repeat_kv(v, n_heads // n_kv_heads)
    o = attn.attention_core(q, k, v, causal=causal, chunk=chunk)
    return qdense(o.reshape(B, S, n_heads * head_dim), qp.wo)
