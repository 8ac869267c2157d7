"""Mixture-of-Experts FFN (port of ``repro.layers.moe``): one device, and
expert parallelism (EP) over a mesh.

The reference runs GShard's two-level capacity dispatch inside
``shard_map``: assignments travel to their expert's shard over an
all-to-all over 'data' (level 1, ``Cs`` slots a destination shard), then
fill per-expert buffers (level 2, ``Ce`` slots a local expert), the
experts run tensor-parallel over 'model', and the results return over a
second all-to-all. On one device there is one shard and the all-to-alls
are the identity; :func:`moe_ffn` keeps both levels there with no mesh:
the slot arithmetic, the capacities and therefore which assignments are
dropped are the reference's.

Under a sharded step's plan whose mesh has an axis above 1 (the context's
``shard``, :class:`repro_torch.parallel.fsdp.ShardPlan`) ``moe_ffn`` is
the reference's EP block on this rank: the expert tables are this rank's
(E / D, d, f / TP) blocks (D the extent of 'data'), the tokens its rows
over the DP axes, the all-to-alls ``core.distributed.exchange`` over
'data', the expert output reduce-scattered over 'model' on d where 'model'
divides d (else all-reduced), the return trip at that width, the combine
in f32 in the reference's slot order (destination shard, then position),
then the cast and the gather over 'model' on d (the residual stream is
whole between layers), and the aux loss the mean over the DP axes. A step
whose rows are every rank's (an engine's chunk, a one-request admission,
lanes the DP extent does not divide: the plan's ``rows_whole``) splits
them over 'data' for the block and gathers the result: the reference has
no such step (its ``shard_map`` needs the batch split over DP).
:func:`moe_ep_plain` is the same EP semantics for D shards of the rows on
one device, for the tests and the card's check.

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
sliced off. The combine sums each token's contributions from 0.0 in f32
in slot order, the order of the reference's sequential scatter-add (on
one shard that is the k order).

The router is a float (d, E) f32 GEMM through ``layers.common.dense``
(the fat GEMM kernel on the card; under ``quant_mode="int8"`` the dynamic
W8A8 path, as the reference's, its activation scale over this shard's
rows only: the reference computes it inside ``shard_map``). The expert products are batched matmuls
on per-call casts of the tables (and per-call dequantizations of
pre-quantized ones), as the reference's ``jnp.einsum`` outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context
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
    capacity and return 0. Over DP the mask may hold every rank's lanes
    while ``x`` holds this rank's. Under a sharded plan over a mesh with
    an axis above 1 the EP block (the module docstring)."""
    plan = current_context().shard
    if plan is not None and any(n > 1 for n in plan.mesh.shape):
        return _moe_ep(p, x, plan, top_k=top_k,
                       capacity_factor=capacity_factor, norm_topk=norm_topk,
                       activation=activation, aux_coef=aux_coef,
                       token_mask=token_mask)
    E = p.w_router.shape[1]
    w_in = _maybe_dequant(p.w_in, x.dtype)
    w_gate = _maybe_dequant(p.w_gate, x.dtype)
    w_out = _maybe_dequant(p.w_out, x.dtype)
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    live = _live(token_mask, B, S, xf.device)
    probs, gates, idx = _route(p, xf, top_k, norm_topk)
    aux = _aux(probs, idx, E)
    d1 = _level1(idx, gates, live, E, 1, capacity_factor)
    xe, d2 = _level2(_send_rows(xf, d1, top_k), d1["send_e"], 1, E,
                     capacity_factor)
    ye = _expert_ffn(xe, w_in, w_gate, w_out, activation)
    y = _combine(_return_rows(ye, d2), d1, top_k, d1["a_gate"], 1)
    return y.reshape(B, S, d).to(x.dtype), aux_coef * aux


def _live(token_mask, B: int, S: int, device) -> torch.Tensor:
    """The (B * S,) live-token mask: every token without ``token_mask``."""
    if token_mask is None:
        return torch.ones((B * S,), dtype=torch.bool, device=device)
    return token_mask.to(torch.bool).expand(B, S).reshape(B * S)


def _route(p: MoeParams, xf, top_k: int, norm_topk: bool):
    # a W8A8 router's activation scale is this shard's, as the
    # reference's ``shard_map`` body computes it
    logits = cm.dense(xf.to(torch.float32), p.w_router, scale_over=None)
    return _top_k_gates(logits, top_k, norm_topk)


def _aux(probs, idx, E: int) -> torch.Tensor:
    """The load-balancing aux loss (Switch): E * sum_e f_e * P_e over the
    rows given (dead ones included, as in the reference)."""
    experts = torch.arange(E, device=probs.device)
    f_e = (idx[:, :1] == experts).to(torch.float32).mean(0)
    return E * torch.sum(f_e * probs.mean(0))


def _level1(idx, gates, live, E: int, D: int, capacity_factor: float
            ) -> dict:
    """Level 1: each assignment to its expert's shard's ``Cs`` slots (dead
    ones to the phantom shard D, whose slots are sliced off). Returns the
    assignment vectors and the (D * Cs,) slot vectors: which assignment
    fills each slot (-1: none) and its local expert id (-1: none)."""
    T, top_k = idx.shape
    dev = idx.device
    E_l = E // D
    n = T * top_k
    a = torch.arange(n, device=dev)
    a_tok = a // top_k
    a_exp = idx.reshape(n)
    a_live = live.index_select(0, a_tok)
    dest = torch.where(a_live, a_exp // E_l, D)
    Cs = _round8(int(capacity_factor * T * top_k / D))
    pos = _positions_in_bucket(dest, D + 1)
    keep = a_live & (pos < Cs)
    pos_c = torch.where(keep, pos, Cs - 1)
    slot = dest * Cs + pos_c
    win = _last_writer(slot, (D + 1) * Cs)[:D * Cs]
    win_c = win.clamp_min(0)
    filled = (win >= 0) & keep.index_select(0, win_c)
    slot_src = torch.where(filled, win, -1)
    # an assignment reaches the combine where it holds its slot
    ok = keep & (slot_src.index_select(0, slot.clamp_max(D * Cs - 1)) == a)
    return {"Cs": Cs, "a_tok": a_tok, "a_gate": gates.reshape(n).to(
                torch.float32), "slot": slot, "ok": ok, "win_c": win_c,
            "filled": filled,
            "send_e": torch.where(filled, a_exp.index_select(0, win_c) % E_l,
                                  -1)}


def _send_rows(xf, d1: dict, top_k: int) -> torch.Tensor:
    """The (D * Cs, d) send buffer: each slot's token row (zeros where no
    assignment holds it)."""
    rows = xf.index_select(0, d1["a_tok"].index_select(0, d1["win_c"]))
    return torch.where(d1["filled"][:, None], rows,
                       torch.zeros((), dtype=xf.dtype, device=xf.device))


def _level2(rx, re, D: int, E_l: int, capacity_factor: float):
    """Level 2: the ``R = D * Cs`` rows received (their local expert ids
    ``re``, -1 for an empty slot) into ``Ce`` slots of each local expert.
    Returns the (E_l, Ce, d) expert input and what the return trip
    needs."""
    R, d = rx.shape
    valid = re >= 0
    re_c = torch.where(valid, re, 0)
    Ce = _round8(int(capacity_factor * R / E_l))
    pos2 = _positions_in_bucket(re_c, E_l)
    keep2 = valid & (pos2 < Ce)
    pos2_c = torch.where(keep2, pos2, Ce - 1)
    slot2 = re_c * Ce + pos2_c
    win2 = _last_writer(slot2, E_l * Ce)
    win2_c = win2.clamp_min(0)
    filled2 = (win2 >= 0) & keep2.index_select(0, win2_c)
    xe = torch.where(filled2[:, None], rx.index_select(0, win2_c),
                     torch.zeros((), dtype=rx.dtype, device=rx.device))
    return xe.reshape(E_l, Ce, d), {"slot2": slot2, "keep2": keep2}


def _return_rows(ye, d2: dict) -> torch.Tensor:
    """Each received row's expert output (zeros where level 2 dropped
    it), in the received order."""
    E_l, Ce, w = ye.shape
    yr = ye.reshape(E_l * Ce, w).index_select(0, d2["slot2"])
    return yr * d2["keep2"][:, None].to(ye.dtype)


def _combine(back, d1: dict, top_k: int, a_gate, D: int) -> torch.Tensor:
    """(T, w) f32: each token's gated contributions summed from 0.0 in
    slot order (``back`` holds each of this rank's send slots' output; on
    one shard slot order is the k order); a dropped assignment adds
    nothing."""
    slot, ok = d1["slot"], d1["ok"]
    n = slot.shape[0]
    w = back.shape[1]
    at = slot.clamp_max(back.shape[0] - 1)
    contrib = torch.where(
        ok[:, None], back.index_select(0, at).to(torch.float32)
        * a_gate[:, None], 0.0).reshape(n // top_k, top_k, w)
    order = torch.where(ok, slot, back.shape[0]).reshape(-1, top_k)
    if D > 1 and top_k > 1:
        contrib = contrib.gather(1, order.argsort(dim=1, stable=True)[
            ..., None].expand(-1, -1, w))
    y = torch.zeros((n // top_k, w), dtype=torch.float32,
                    device=back.device)
    for k in range(top_k):
        y = y + contrib[:, k]
    return y


def _tables(p: MoeParams, dtype):
    """The expert tables in the products' orientation and ``dtype`` (a
    pre-quantized table dequantized), and whether they are this rank's
    'model' blocks (tensor parallelism inside the experts)."""
    first = p.w_in.w_q if isinstance(p.w_in, QuantizedLinear) else p.w_in
    tp = cd.model_block_dim(first) is not None
    return (_maybe_dequant(p.w_in, dtype), _maybe_dequant(p.w_gate, dtype),
            _maybe_dequant(p.w_out, dtype), tp)


def _moe_ep(p: MoeParams, x, plan, *, top_k, capacity_factor, norm_topk,
            activation, aux_coef, token_mask):
    """The reference's EP block on this rank (the module docstring)."""
    mesh = plan.mesh
    E = p.w_router.shape[1]
    D = mesh.axis_size("data")
    if E % D:
        raise ValueError(f"n_experts={E} not divisible by EP degree {D}")
    E_l = E // D
    w_in, w_gate, w_out, tp = _tables(p, x.dtype)
    if w_in.shape[0] != E_l:
        raise ValueError(f"the expert tables hold {w_in.shape[0]} experts "
                         f"on this rank, not E / D = {E_l}: a sharded plan "
                         "keeps their blocks (parallel.fsdp.ShardPlan)")
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    dp_entry, dp_size, dp_index = cd.data_parallel(mesh)
    if token_mask is not None and token_mask.shape[0] not in (1, B):
        # every rank's lanes: this rank's
        token_mask = token_mask[dp_index * B:(dp_index + 1) * B]
    live = _live(token_mask, B, S, xf.device)
    dp_axes = mesh.dp_axes()
    if plan.rows_whole and D > 1:
        # every rank's rows: this rank's share of them over 'data'
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "a MoE step under autograd with rows whole on every DP "
                "rank: split the batch over the DP axes")
        t_l = -(-T // D)
        pad = t_l * D - T
        lo = mesh.axis_index("data") * t_l
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))[lo:lo + t_l]
        live = torch.nn.functional.pad(live, (0, pad))[lo:lo + t_l]
        dp_axes = ("data",)
    probs, gates, idx = _route(p, xf, top_k, norm_topk)
    aux = cd.mean_over(_aux(probs, idx, E), mesh, dp_axes)

    d1 = _level1(idx, gates, live, E, D, capacity_factor)
    recv_x = cd.exchange(_send_rows(xf, d1, top_k), mesh, "data")
    recv_e = cd.all_to_all(d1["send_e"].to(torch.int32), mesh, "data")
    xe, d2 = _level2(recv_x, recv_e.long(), D, E_l, capacity_factor)
    scatter = tp and d % mesh.axis_size("model") == 0
    if tp:
        xe = cd.copy_to_model(xe, mesh)
    ye = _expert_ffn(xe, w_in, w_gate, w_out, activation)
    if tp:
        ye = cd.reduce_scatter_to_model(ye, mesh, 2) if scatter else \
            cd.reduce_from_model(ye, mesh)
    back = cd.exchange(_return_rows(ye, d2), mesh, "data")
    a_gate = d1["a_gate"]
    if scatter:  # each rank's gates meet its d block: their gradient sums
        a_gate = cd.copy_to_model(a_gate, mesh)
    y = _combine(back, d1, top_k, a_gate, D).to(x.dtype)
    if scatter:
        y = cd.gather_from_model(y, mesh, -1)
    if plan.rows_whole and D > 1:
        y = cd.all_gather(y, mesh, "data", 0)[:T]
    return y.reshape(B, S, d), aux_coef * aux


def moe_ep_plain(p: MoeParams, x: torch.Tensor, shards: int, *,
                 top_k: int, capacity_factor: float = 1.25,
                 norm_topk: bool = True, activation: str = "silu",
                 aux_coef: float = 0.01,
                 token_mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The EP block's semantics on one device, for ``shards`` DP shards of
    ``x``'s rows (B divisible by ``shards``) and as many expert shards:
    each shard routes its rows (level 1 at its own ``Cs``), the D send
    buffers are stacked and exchanged as the transpose of (D_src, D_dst,
    Cs), each expert shard fills its level 2 from the D * Cs rows it
    receives in source order, the outputs return by the same transpose and
    each shard combines in slot order; the aux loss is the shards' mean.
    The whole tables, no tensor parallelism: the plain version the tests
    and the card hold the mesh path to."""
    E = p.w_router.shape[1]
    D = shards
    B, S, d = x.shape
    if E % D or B % D:
        raise ValueError(f"{D} shards must divide n_experts={E} and the "
                         f"batch {B}")
    E_l = E // D
    w_in = _maybe_dequant(p.w_in, x.dtype)
    w_gate = _maybe_dequant(p.w_gate, x.dtype)
    w_out = _maybe_dequant(p.w_out, x.dtype)
    rows = B // D
    xs = x.reshape(D, rows * S, d)
    live = _live(token_mask, B, S, x.device).reshape(D, rows * S)
    levels, auxes = [], []
    for s in range(D):
        probs, gates, idx = _route(p, xs[s], top_k, norm_topk)
        auxes.append(_aux(probs, idx, E))
        levels.append(_level1(idx, gates, live[s], E, D, capacity_factor))
    Cs = levels[0]["Cs"]
    send_x = torch.stack([_send_rows(xs[s], levels[s], top_k)
                          for s in range(D)]).reshape(D, D, Cs, d)
    send_e = torch.stack([lv["send_e"] for lv in levels]).reshape(D, D, Cs)
    recv_x = send_x.transpose(0, 1).reshape(D, D * Cs, d)
    recv_e = send_e.transpose(0, 1).reshape(D, D * Cs)
    outs = []
    for r in range(D):
        sl = slice(r * E_l, (r + 1) * E_l)
        xe, d2 = _level2(recv_x[r], recv_e[r], D, E_l, capacity_factor)
        ye = _expert_ffn(xe, w_in[sl], None if w_gate is None else
                         w_gate[sl], w_out[sl], activation)
        outs.append(_return_rows(ye, d2).reshape(D, Cs, d))
    back = torch.stack(outs).transpose(0, 1).reshape(D, D * Cs, d)
    y = torch.stack([_combine(back[s], levels[s], top_k,
                              levels[s]["a_gate"], D) for s in range(D)])
    aux = torch.stack(auxes).mean()
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
