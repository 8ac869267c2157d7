"""Mixture-of-Experts FFN (port of ``repro.layers.moe``) on one device.

The reference runs GShard's two-level capacity dispatch inside
``shard_map``: assignments travel to their expert's shard over an
all-to-all (level 1, ``Cs`` slots a shard), then fill per-expert buffers
(level 2, ``Ce`` slots an expert). On one device there is one shard, the
all-to-alls are the identity, and this module keeps both levels with no
mesh: the slot arithmetic, the capacities and therefore which assignments
are dropped are the reference's.

Capacities come from the static token count, and every step is a
fixed-shape tensor op with no value read back to the host, so the block
runs on the ``meta`` device (plan warm-up) and inside a captured CUDA
graph. The reference writes slots with ``.at[...].set(mode="drop")``,
which on the CPU keeps the *last* of duplicate writes: unfilled level-2
slots write zeros onto expert 0's slot ``Ce - 1`` after the valid ones,
and a dropped assignment writes zeros onto its bucket's slot ``Cs - 1``,
so an assignment held there is lost even when nothing overflowed. Here
each slot's writer is the scatter-``amax`` of the writing indices (the
last writer, whatever the order the device runs the scatter in), then a
gather: the reference's results, deterministically. Writes the reference
drops (dead tokens, sent to the phantom shard) go to a bucket that is
sliced off. The combine sums each token's contributions in k order from
0.0 in f32, the order of the reference's sequential scatter-add.

The router is a float (d, E) f32 GEMM through ``layers.common.dense``
(the fat GEMM kernel on the card; under ``quant_mode="int8"`` the dynamic
W8A8 path, as the reference's). The expert products are batched matmuls
on per-call casts of the tables (and per-call dequantizations of
pre-quantized ones), as the reference's ``jnp.einsum`` outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import apply_activation
from repro_torch.layers import common as cm
from repro_torch.quant.int8 import QuantizedLinear


class MoeParams(NamedTuple):
    w_router: torch.Tensor             # (d, E) f32
    w_in: torch.Tensor                 # (E, d, f)
    w_gate: torch.Tensor | None        # (E, d, f): gated (SwiGLU) experts
    w_out: torch.Tensor                # (E, f, d)


def init_moe(gen, d_model, d_ff, n_experts, *, gated=True,
             dtype=torch.float32, lead=(), device) -> MoeParams:
    """``lead`` prepends stacking dims (the layer axis) to every leaf."""
    shape = (n_experts, d_model, d_ff)
    w = lambda shape, dt, scale=None: cm.normal_init(
        gen, shape, dt, scale, lead=lead, device=device)
    return MoeParams(
        w_router=w((d_model, n_experts), torch.float32),
        w_in=w(shape, dtype, d_model ** -0.5),
        w_gate=w(shape, dtype, d_model ** -0.5) if gated else None,
        w_out=w((n_experts, d_ff, d_model), dtype, d_ff ** -0.5),
    )


def moe_axes(gated=True) -> MoeParams:
    return MoeParams(
        w_router=("embed", None),
        w_in=("expert", "embed", "ffn"),
        w_gate=("expert", "embed", "ffn") if gated else None,
        w_out=("expert", "ffn", "embed"),
    )


def _round8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


def _maybe_dequant(w, dtype: torch.dtype):
    """A pre-quantized expert table (..., N, K) int8 + (..., N) scales ->
    float (..., K, N) in the product's orientation, at every call; a float
    table passes through."""
    if isinstance(w, QuantizedLinear):
        wf = w.w_q.to(torch.float32) * w.w_scale[..., :, None]
        return wf.transpose(-1, -2).to(dtype)
    return w


def _positions_in_bucket(bucket: torch.Tensor, n_buckets: int
                         ) -> torch.Tensor:
    """Each element's running index within its bucket (cumsum of
    one-hots, compared against an arange: no host sync)."""
    ids = torch.arange(n_buckets, device=bucket.device)
    pos = torch.cumsum((bucket[:, None] == ids).long(), dim=0) - 1
    return pos.gather(1, bucket[:, None])[:, 0]


def _top_k_gates(logits: torch.Tensor, top_k: int, norm_topk: bool):
    """(probs, gates, idx). ``torch.topk`` ranks as ``lax.top_k`` does
    but for ties, which random f32 router logits make improbable."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    if norm_topk:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def _last_writer(slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For each of ``n_slots`` slots, the index of the last element of
    ``slots`` that names it, or -1: what a sequential scatter leaves."""
    order = torch.arange(slots.shape[0], device=slots.device)
    win = torch.full((n_slots,), -1, dtype=torch.long, device=slots.device)
    return win.scatter_reduce(0, slots, order, reduce="amax")


def _expert_ffn(xe, w_in, w_gate, w_out, activation):
    """xe: (E, C, d); tables (E, d, f) / (E, f, d), cast to xe's dtype."""
    h = torch.bmm(xe, w_in.to(xe.dtype))
    if w_gate is not None:
        g = torch.bmm(xe, w_gate.to(xe.dtype))
        h = apply_activation(g, activation) * h
    else:
        h = apply_activation(h, activation)
    return torch.bmm(h, w_out.to(xe.dtype))


def moe_ffn(
    p: MoeParams,
    x: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    norm_topk: bool = True,
    activation: str = "silu",
    aux_coef: float = 0.01,
    token_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d) in x's dtype, aux_coef * the Switch load-balancing
    loss). ``token_mask`` (B, S), broadcast if smaller, marks live tokens:
    dead ones (vacant engine lanes, a chunk's pad positions) take no
    capacity and return 0."""
    E = p.w_router.shape[1]
    D, E_l = 1, E                         # one expert shard
    w_in = _maybe_dequant(p.w_in, x.dtype)
    w_gate = _maybe_dequant(p.w_gate, x.dtype)
    w_out = _maybe_dequant(p.w_out, x.dtype)
    B, S, d = x.shape
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)
    live = (torch.ones((T,), dtype=torch.bool, device=dev)
            if token_mask is None else
            token_mask.to(torch.bool).expand(B, S).reshape(T))
    logits = cm.dense(xf.to(torch.float32), p.w_router)
    probs, gates, idx = _top_k_gates(logits, top_k, norm_topk)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    experts = torch.arange(E, device=dev)
    f_e = (idx[:, :1] == experts).to(torch.float32).mean(0)
    aux = E * torch.sum(f_e * probs.mean(0))

    # level 1: assignments to their shard's Cs slots; dead ones to the
    # phantom shard D, whose slots are sliced off
    n = T * top_k
    a = torch.arange(n, device=dev)
    a_tok = a // top_k
    a_exp = idx.reshape(n)
    a_gate = gates.reshape(n).to(torch.float32)
    a_live = live.index_select(0, a_tok)
    dest = torch.where(a_live, a_exp // E_l, D)
    Cs = _round8(int(capacity_factor * T * top_k / D))
    pos = _positions_in_bucket(dest, D + 1)
    keep = a_live & (pos < Cs)
    pos_c = torch.where(keep, pos, Cs - 1)
    win = _last_writer(dest * Cs + pos_c, (D + 1) * Cs)[:D * Cs]
    win_c = win.clamp_min(0)
    filled = (win >= 0) & keep.index_select(0, win_c)
    slot_src = torch.where(filled, win, -1)
    send_e = torch.where(filled, a_exp.index_select(0, win_c) % E_l, -1)
    send_x = torch.where(filled[:, None],
                         xf.index_select(0, a_tok.index_select(0, win_c)),
                         0).to(x.dtype)

    # level 2: received slots into per-expert buffers of Ce slots
    R = D * Cs
    valid = send_e >= 0
    re_c = torch.where(valid, send_e, 0)
    Ce = _round8(int(capacity_factor * R / E_l))
    pos2 = _positions_in_bucket(re_c, E_l)
    keep2 = valid & (pos2 < Ce)
    pos2_c = torch.where(keep2, pos2, Ce - 1)
    slot2 = re_c * Ce + pos2_c
    win2 = _last_writer(slot2, E_l * Ce)
    win2_c = win2.clamp_min(0)
    filled2 = (win2 >= 0) & keep2.index_select(0, win2_c)
    xe = torch.where(filled2[:, None], send_x.index_select(0, win2_c), 0)
    ye = _expert_ffn(xe.reshape(E_l, Ce, d), w_in, w_gate, w_out,
                     activation)

    # return trip: expert buffers -> level-1 slots -> each assignment
    yr = ye.reshape(E_l * Ce, d).index_select(0, slot2) \
        * keep2[:, None].to(ye.dtype)
    ok = keep & (slot_src.index_select(0, pos_c) == a)
    contrib = torch.where(
        ok[:, None], yr.index_select(0, pos_c).to(torch.float32)
        * a_gate[:, None], 0.0).reshape(T, top_k, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for k in range(top_k):
        y = y + contrib[:, k]
    return y.reshape(B, S, d).to(x.dtype), aux_coef * aux


def moe_ref(p: MoeParams, x: torch.Tensor, *, top_k: int,
            norm_topk: bool = True, activation: str = "silu"
            ) -> torch.Tensor:
    """Dense (no-drop) reference: y = sum_k gate_k * FFN_{e_k}(x). Accepts
    pre-quantized expert tables like :func:`moe_ffn` does."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf.to(torch.float32) @ p.w_router
    _, gates, idx = _top_k_gates(logits, top_k, norm_topk)
    w_in = _maybe_dequant(p.w_in, xf.dtype).to(xf.dtype)
    w_gate = _maybe_dequant(p.w_gate, xf.dtype)
    w_out = _maybe_dequant(p.w_out, xf.dtype).to(xf.dtype)
    h = torch.einsum("td,edf->tef", xf, w_in)
    if w_gate is not None:
        g = torch.einsum("td,edf->tef", xf, w_gate.to(xf.dtype))
        h = apply_activation(g, activation) * h
    else:
        h = apply_activation(h, activation)
    y_all = torch.einsum("tef,efd->ted", h, w_out)
    y = torch.zeros((xf.shape[0], d), dtype=torch.float32, device=x.device)
    for k in range(top_k):
        sel = y_all.gather(1, idx[:, k, None, None].expand(-1, 1, d))[:, 0]
        y = y + gates[:, k, None] * sel.to(torch.float32)
    return y.reshape(B, S, d).to(x.dtype)
