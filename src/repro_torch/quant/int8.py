"""Symmetric int8 quantization: calibration, quantize/dequantize, scales
(port of ``repro.quant.int8``, the port's own copy: the reference module
imports jax).

Conventions (the reference's ``docs/quantization.md``):

* **Symmetric, zero-point-free.** ``q = clip(round(x / scale), -127, 127)``,
  ``x ≈ q * scale``. −128 is never produced, so the int8 GEMM's i32
  accumulator bound is K · 127² and the saturating epilogue is the only
  clipping point.
* **Per-tensor** scales are 0-d; **per-channel** scales carry one entry per
  output channel: for a (K, N) weight that is axis=1, shape (N,), which
  lands on the GEMM's N dimension so the fused epilogue applies it per
  output column in the kernel.
* Scale propagation through C = A·B: ``c_real ≈ acc_i32 · (s_a · s_b)``.

Every function is plain torch ops on the tensor's own device, with no value
read back to the host, so they run inside a captured CUDA graph and on the
meta device (the plan warm-up). Rounding is ``torch.round`` (half to even,
as ``jnp.round``) of the f32 quotient ``x / scale``; a reciprocal multiply
or a bf16 quotient would flip ties against the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

QMAX = 127  # symmetric: the int8 grid is [-127, 127]
_EPS = 1e-12


def _absmax(x: torch.Tensor, axis: int | None) -> torch.Tensor:
    """abs-max of x in f32: over everything (axis=None) or per channel on
    ``axis``."""
    x = x.to(torch.float32).abs()
    if axis is None:
        return x.amax()
    red = tuple(d for d in range(x.dim()) if d != axis % x.dim())
    return x.amax(dim=red)


def _safe_scale(amax: torch.Tensor) -> torch.Tensor:
    """absmax -> scale, guarding all-zero inputs: a zero input gets scale
    exactly 1.0 (it quantizes to 0 at any scale), never eps/127."""
    return torch.where(amax > 0.0, torch.clamp_min(amax, _EPS) / QMAX, 1.0)


def _broadcast(scale: torch.Tensor, ndim: int, axis: int | None
               ) -> torch.Tensor:
    if axis is None:
        return scale
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return scale.reshape(shape)


def absmax_scale(x: torch.Tensor, axis: int | None = None, *,
                 reduce=None) -> torch.Tensor:
    """Symmetric absmax calibration scale (1.0 for all-zero inputs).

    axis=None -> per-tensor 0-d scale; axis=i -> per-channel scales for
    channels on axis ``i`` (reduced over every other axis). ``reduce``
    maps the local absmax before the scale is taken: a MAX over the ranks
    that hold the rest of the tensor (``core.distributed.scale_max``).
    """
    amax = _absmax(x, axis)
    return _safe_scale(amax if reduce is None else reduce(amax))


def quantize(x: torch.Tensor, scale: torch.Tensor,
             axis: int | None = None) -> torch.Tensor:
    """x -> int8 on the symmetric grid; ``scale`` broadcasts per ``axis``.
    A non-positive scale is treated as 1.0."""
    scale = _broadcast(scale, x.dim(), axis)
    scale = torch.where(scale > 0.0, scale, 1.0)
    q = (x.to(torch.float32) / scale).round_()
    return q.clamp_(-QMAX, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               axis: int | None = None) -> torch.Tensor:
    scale = _broadcast(scale, q.dim(), axis)
    return q.to(torch.float32) * torch.where(scale > 0.0, scale, 1.0)


def quantize_block(x: torch.Tensor, reduce=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV pool blocks ``(..., block_size, Hkv, Dh)`` to int8 with
    per-block, per-kv-head scales ``(..., Hkv)`` (the token and feature
    axes reduced away). All-zero blocks get scale 1.0, never 0.
    ``reduce`` maps the ``(..., Hkv)`` absmax before the scale is taken (a
    pool whose head_dim lies over 'model': the MAX over its ranks)."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=(-3, -1))
    scale = _safe_scale(amax if reduce is None else reduce(amax))
    q = (x / scale[..., None, :, None]).round_()
    return q.clamp_(-QMAX, QMAX).to(torch.int8), scale


def dequantize_block(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert :func:`quantize_block`: int8 blocks ``(..., bs, Hkv, Dh)``
    with ``(..., Hkv)`` scales back to ``dtype``."""
    return (q.to(torch.float32) * scale[..., None, :, None]).to(dtype)


class QTensor(NamedTuple):
    """An int8 tensor with its per-tensor (0-d) or per-channel scale."""

    q: torch.Tensor       # int8
    scale: torch.Tensor   # f32, () or (C,)


def quantize_per_tensor(x: torch.Tensor) -> QTensor:
    s = absmax_scale(x)
    return QTensor(q=quantize(x, s), scale=s)


def quantize_per_channel(x: torch.Tensor, axis: int) -> QTensor:
    s = absmax_scale(x, axis=axis)
    return QTensor(q=quantize(x, s, axis=axis), scale=s)


class Calibrator:
    """Running absmax observer for post-training calibration.

        cal = Calibrator(axis=1)        # per-channel over axis 1
        for batch in data: cal.observe(batch)
        s = cal.scale()
    """

    def __init__(self, axis: int | None = None):
        self.axis = axis
        self._amax: torch.Tensor | None = None

    def observe(self, x) -> "Calibrator":
        amax = _absmax(torch.as_tensor(x), self.axis)
        self._amax = (amax if self._amax is None
                      else torch.maximum(self._amax, amax))
        return self

    def scale(self) -> torch.Tensor:
        if self._amax is None:
            raise ValueError("Calibrator.scale() before any observe()")
        return _safe_scale(self._amax)


def combine_scales(*scales: torch.Tensor) -> torch.Tensor:
    """Product of scales with broadcasting: the GEMM scale propagation rule
    ``s_out = s_a · s_b``."""
    out = scales[0]
    for s in scales[1:]:
        out = out * s
    return out


class QuantizedLinear(NamedTuple):
    """An int8 linear: y = x @ dequant(w_q) + bias.

    w_q:     int8 (N, K), contiguous: the GEMM's col-layout B
    w_scale: f32  (N,)    per-output-channel symmetric scales
    bias:    f32  (N,) | None, in real (dequantized) units

    In a stacked parameter tree the leaves carry a leading layer dim.
    """

    w_q: torch.Tensor
    w_scale: torch.Tensor
    bias: torch.Tensor | None


def quantize_linear(w: torch.Tensor, bias: torch.Tensor | None = None
                    ) -> QuantizedLinear:
    """PTQ of a (..., K, N) float weight to per-channel int8 in (..., N, K)
    layout; leading dims (stacked layers) each get their own scales, as
    the reference's vmap over them does. ``w_q`` is made contiguous: the
    kernel reads B in place. A stacked weight is quantized one (K, N)
    slice at a time, into preallocated outputs: its f32 temporaries are
    one slice's, never the whole leaf's (llama-3.2-vision's stacked MLP
    input is 7.5 GB of f32)."""
    bias = None if bias is None else bias.to(torch.float32)
    if w.dim() > 2:
        *lead, K, N = w.shape
        flat = w.reshape(-1, K, N)
        w_q = torch.empty((flat.shape[0], N, K), dtype=torch.int8,
                          device=w.device)
        w_scale = torch.empty((flat.shape[0], N), dtype=torch.float32,
                              device=w.device)
        for i in range(flat.shape[0]):
            part = quantize_linear(flat[i])
            w_q[i].copy_(part.w_q)
            w_scale[i].copy_(part.w_scale)
        return QuantizedLinear(w_q=w_q.reshape(*lead, N, K),
                               w_scale=w_scale.reshape(*lead, N), bias=bias)
    scale = _safe_scale(w.to(torch.float32).abs().amax(dim=-2))
    q = quantize(w, scale[..., None, :])
    return QuantizedLinear(w_q=q.transpose(-1, -2).contiguous(),
                           w_scale=scale, bias=bias)
