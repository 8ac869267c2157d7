"""Shared layer utilities (port of ``repro.layers.common``): parameter
init, the ``dense()`` GEMM wrapper, norms, rotary embeddings.

Every matmul routes through :func:`dense`, which calls
``repro_torch.core.gemm.balanced_gemm``: the planned hand-written kernels on
a CUDA tensor, their plain versions on a CPU tensor. A pre-quantized weight
(:class:`QuantizedLinear`) and, under ``quant_mode="int8"``, a float one
take the W8A8 path of :mod:`repro_torch.layers.quantized`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context
from repro_torch.core.gemm import balanced_gemm
from repro_torch.quant.int8 import QuantizedLinear


def dense(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    activation: str | None = None,
    out_dtype: torch.dtype | None = None,
    scale_over=(),
) -> torch.Tensor:
    """x @ w (+bias, +activation) through the balanced-GEMM substrate.

    ``w`` is a float (K, N) weight or a pre-quantized
    :class:`QuantizedLinear` (int8 (N, K) + per-channel scales; the bias,
    if any, is taken in f32). A float weight under ``quant_mode="int8"``
    takes the dynamic W8A8 path (re-quantized at every call). Otherwise a
    bf16 ``x`` times an f32 ``w`` is promoted to f32 inside the GEMM, as
    the reference's ``dot_general`` does. The result is cast to
    ``out_dtype`` (default ``x.dtype``). ``scale_over``: the W8A8
    activation scale's mesh axes besides the rows' DP cut
    (``layers.quantized.activation_scale``; None: local).
    """
    out_dtype = out_dtype or x.dtype
    if cd.is_w8a8(x, w):
        from repro_torch.layers import quantized as qz

        return qz.w8a8(x, w, bias, activation=activation,
                       out_dtype=out_dtype, scale_over=scale_over)
    return balanced_gemm(x, w, bias, out_dtype=out_dtype,
                         activation=activation)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids``. Vocab-parallel (Megatron-style, the
    reference's ``embed_lookup(mesh=)``) when ``table`` is this rank's
    block of rows over 'model' (:func:`block_dim`): each rank looks up its
    own rows, zeroes the ids outside them and the ranks' rows are summed
    (an ``all_reduce`` of the (B, S, d) activations, not of the table)."""
    if block_dim(table) != 0:
        return table[ids]
    mesh = tp_mesh()
    n = table.shape[0]
    local = ids - mesh.axis_index("model") * n
    ok = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return cd.reduce_from_model(rows, mesh)


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


# ------------------------------------------------------------------ mesh
# The mesh a sharded step runs over is recorded in the active GemmContext
# (``use_context(mesh=...)``, the reference's ``set_activation_mesh``), so
# layers can read its extents without threading it through every
# signature.
def axis_size(name: str) -> int:
    """The extent of mesh axis ``name`` in the active context (1 with no
    mesh, or an axis it lacks)."""
    mesh = current_context().mesh
    return 1 if mesh is None else mesh.axis_size(name)


def tp_size() -> int:
    """The extent of 'model' a sharded plan computes tensor-parallel over
    (the context's ``shard``; 1 without one)."""
    plan = current_context().shard
    return 1 if plan is None else plan.tp


def tp_mesh():
    """The mesh of the active sharded plan."""
    return current_context().shard.mesh


def block_dim(t: torch.Tensor | None) -> int | None:
    """The dim along which ``t`` is this rank's 'model' block under the
    active plan (None: ``t`` is whole)."""
    return cd.model_block_dim(t) if tp_size() > 1 else None


def model_whole(t: torch.Tensor | None, *, partial: bool):
    """``t`` whole over 'model'. A block is gathered; its gradient is then
    this rank's block of the ranks' gradients, summed (``partial``: each
    rank computes with the whole leaf its own share of the rows) or not
    (every rank computes alike). A whole leaf stays as it is, with its
    gradient summed over 'model' when ``partial``. A ``QuantizedLinear``
    field by field."""
    if t is None or tp_size() == 1:
        return t
    if isinstance(t, QuantizedLinear):
        return QuantizedLinear(*(model_whole(f, partial=partial) for f in t))
    dim = block_dim(t)
    if dim is None:
        return cd.copy_to_model(t, tp_mesh()) if partial else t
    return cd.gather_from_model(t, tp_mesh(), dim, sum_grad=partial)


def _split_dim(shape, full) -> int | None:
    """The one dim along which ``shape`` is a 'model' block of ``full``
    (None: whole)."""
    dims = [d for d, (a, b) in enumerate(zip(shape, full)) if a != b]
    if len(shape) != len(full) or len(dims) > 1 or (
            dims and shape[dims[0]] * tp_size() != full[dims[0]]):
        raise ValueError(f"{tuple(shape)} is not a block over 'model' "
                         f"({tp_size()}) of {tuple(full)}")
    return dims[0] if dims else None


def relayout(t: torch.Tensor, full, shape) -> torch.Tensor:
    """``t``, a leaf of shape ``full`` as one rank holds it (whole, or its
    'model' block along the one dim its shape shows smaller), in the
    layout that ``shape`` shows: ``t`` itself where they agree, this
    rank's block of a whole ``t``, the blocks gathered for a whole
    ``shape``, else one all-to-all over 'model' (``cd.resplit``). A
    decode state read into the layout a layer computes with, and its new
    value written back into the state's layout (no gradient)."""
    have, want = _split_dim(t.shape, full), _split_dim(shape, full)
    if have == want:
        return t
    mesh = tp_mesh()
    if have is None:
        return cd.local_block(t, want, mesh, "model")
    if want is None:
        return cd.all_gather(t, mesh, "model", have).contiguous()
    return cd.resplit(t, mesh, "model", have, want)


def gathered(lp, path: str = "layers", lead: int = 1):
    """One layer's slice ``lp`` of the stacked parameter subtree at
    ``path``, whole: under a sharded step's plan (the context's ``shard``,
    :class:`repro_torch.parallel.fsdp.ShardPlan`) each leaf is gathered
    from this rank's block; with no plan, ``lp`` as it is. The models call
    it where a layer takes its slice, inside the remat boundary."""
    plan = current_context().shard
    return lp if plan is None else plan.layer(lp, path, lead)
