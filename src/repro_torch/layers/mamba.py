"""Mamba-2 (SSD) block of the zamba2 hybrid family (port of
``repro.layers.mamba``).

The in and out projections are GEMMs through :func:`cm.dense` (the fat
GEMM and GEMV kernels). The depthwise causal conv and the SSM state update
(a per-head outer-product recurrence, state ``head_dim x d_state`` in f32)
are torch ops: the reference runs them as jnp code and a ``lax.scan``, not
as a Pallas kernel. A decode step (T = 1) is one :func:`_ssd_step`; longer
inputs run in chunks of ``CHUNK`` tokens (the reference's ``chunk``; any T,
the last chunk padded) in the SSD chunk form (:func:`_ssd_chunks`), a
group of ``GROUP`` chunks at a time, each group from the state the one
before left and, under grad, recomputed in the backward
(``core.gemm.checkpointed``): the backward keeps one state a group, where
the reference's ``jax.checkpoint`` of each chunk's scan keeps one a chunk,
and a group's work while its backward runs. The forward is the
reference's recurrence in another summation order. Grouping bounds the
torch ops a layer runs (~45 a group): the meta device's dry run counts a
32k-token prefill in seconds, and the card's launches drop with them.

Tensor parallelism over 'model' (under a sharded plan whose extent
divides the SSM heads and which holds this rank's blocks of ``w_in``,
``w_out`` and ``norm_g``, :func:`tp_extent`): a rank runs its H/TP
heads. Its input columns are z and x of its heads, B and C whole and dt
of its heads. ``w_in``'s stored block of columns cuts across the z | x B
C | dt segments, so a rank runs one product with the block it holds, the
ranks' outputs are all-gathered (activations, not the weight) and it
takes its columns. The conv runs on those channels, the
SSM scan on its heads; the gated RMSNorm's f32 sum of squares is summed
over 'model' before the scale, and ``w_out`` is row-parallel (one
all-reduce). The conv state stays whole on every rank: the ranks' new
x-channel inputs are all-gathered. Otherwise the leaves are gathered
whole and every rank computes alike.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as cd
from repro_torch.core.gemm import checkpointed
from repro_torch.layers import common as cm

CONV_K = 4  # depthwise causal conv width
CHUNK = 64  # tokens a chunk of the SSM scan (the reference's ``chunk``)
GROUP = 16  # chunks computed together, and recomputed together under grad


class MambaParams(NamedTuple):
    w_in: torch.Tensor       # (d, 2*d_inner + 2*d_state + n_heads)
    conv_w: torch.Tensor     # (CONV_K, d_inner + 2*d_state)
    conv_b: torch.Tensor     # (d_inner + 2*d_state,)
    a_log: torch.Tensor      # (n_heads,)
    d_skip: torch.Tensor     # (n_heads,)
    dt_bias: torch.Tensor    # (n_heads,)
    norm_g: torch.Tensor     # (d_inner,) gated RMSNorm
    w_out: torch.Tensor      # (d_inner, d)


def dims(d_model: int, d_state: int, *, expand: int = 2,
         head_dim: int = 64) -> tuple[int, int]:
    """(d_inner, n_heads)."""
    d_inner = expand * d_model
    return d_inner, d_inner // head_dim


def init_mamba(gen, d_model, d_state, *, expand=2, head_dim=64,
               dtype=torch.float32, lead=(), device) -> MambaParams:
    """``lead`` prepends stacking dims (the layer axis) to every leaf."""
    d_inner, n_heads = dims(d_model, d_state, expand=expand,
                            head_dim=head_dim)
    d_proj = 2 * d_inner + 2 * d_state + n_heads
    d_conv = d_inner + 2 * d_state
    full = lambda v: v.to(dtype).expand(*lead, *v.shape).clone()
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=device))
    return MambaParams(
        w_in=cm.normal_init(gen, (d_model, d_proj), dtype, lead=lead,
                            device=device),
        conv_w=cm.normal_init(gen, (CONV_K, d_conv), dtype, scale=0.5,
                              lead=lead, device=device),
        conv_b=torch.zeros((*lead, d_conv), dtype=dtype, device=device),
        a_log=full(a_log),
        d_skip=torch.ones((*lead, n_heads), dtype=dtype, device=device),
        dt_bias=torch.full((*lead, n_heads), -4.0, dtype=dtype,
                           device=device),
        norm_g=torch.ones((*lead, d_inner), dtype=dtype, device=device),
        w_out=cm.normal_init(gen, (d_inner, d_model), dtype, lead=lead,
                             device=device),
    )


def mamba_axes() -> MambaParams:
    return MambaParams(
        w_in=("embed", "ffn"), conv_w=(None, "conv"), conv_b=("conv",),
        a_log=(None,), d_skip=(None,), dt_bias=(None,),
        norm_g=("ffn",), w_out=("ffn", "embed"),
    )


class MambaState(NamedTuple):
    ssm: torch.Tensor    # (B, n_heads, head_dim, d_state) f32
    conv: torch.Tensor   # (B, CONV_K-1, d_conv) rolling conv inputs


def init_state(batch, d_model, d_state, *, expand=2, head_dim=64,
               dtype=torch.float32, device) -> MambaState:
    d_inner, n_heads = dims(d_model, d_state, expand=expand,
                            head_dim=head_dim)
    return MambaState(
        ssm=torch.zeros((batch, n_heads, head_dim, d_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_K - 1, d_inner + 2 * d_state),
                         dtype=dtype, device=device),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time. x: (B, T, C); prefix: (B, K-1, C).
    The K products are summed in x's dtype in the reference's order, the
    bias added before the silu; returns (out, the last K-1 inputs)."""
    T = x.shape[1]
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(CONV_K))
    out = F.silu(out + b.to(x.dtype))
    return out, xp[:, -(CONV_K - 1):]


def _ssd_step(state: torch.Tensor, xh, Bt, Ct, dt, a, d_skip
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """h' = exp(-a*dt) h + dt * x ⊗ B ;  y = h'·C + D*x  (per head).
    xh: (B, H, P); Bt, Ct: (B, N); dt: (B, H); a, d_skip: (H,)."""
    decay = torch.exp(-a[None, :] * dt)                       # (B, H)
    dBx = (dt[..., None] * xh)[..., None] * Bt[:, None, None, :]
    new = decay[..., None, None] * state + dBx                # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", new, Ct) + d_skip[None, :, None] * xh
    return new, y


def tp_extent(p: MambaParams, n_heads: int) -> int:
    """The extent of 'model' over which :func:`mamba_block` splits its SSM
    heads: the active plan's where it divides ``n_heads``, ``w_in`` is
    this rank's block of columns and ``w_out`` and ``norm_g`` its blocks
    of rows; else 1 (the leaves whole)."""
    tp = cm.tp_size()
    if tp == 1 or n_heads % tp or cm.block_dim(p.w_in) != 1 or \
            cm.block_dim(p.w_out) != 0 or cm.block_dim(p.norm_g) != 0:
        return 1
    return tp


def _decays(x: torch.Tensor) -> torch.Tensor:
    """``[..., t, s] = exp(Σ_{s<r<=t} x_r)`` for s <= t, else 0, over x's
    last dim (log decays): the segment sums as a masked cumsum, not a
    difference of two cumsums, so a strong decay underflows to 0 rather
    than cancelling."""
    n = x.shape[-1]
    causal = torch.ones((n, n), dtype=x.dtype, device=x.device).tril()
    return (x[..., None] * causal.tril(-1)).cumsum(-2).exp() * causal


def _ssd_chunks(h, xh, Bc, Cc, dt, a, d_skip
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_ssd_step` over K chunks of L tokens at once (the SSD chunk
    form, f32): (y (B, K, L, H, P), the state after the last token). xh:
    (B, K, L, H, P); Bc, Cc: (B, K, L, N); dt: (B, K, L, H). Within a chunk,
    with ``la = -a dt``, ``seg[t, s] = Σ_{s<r<=t} la_r`` and ``cum_t =
    Σ_{r<=t} la_r``: ``y_t = Σ_{s<=t} e^seg[t,s] (C_t·B_s) dt_s x_s +
    e^cum_t C_t·h_k + D x_t`` (y_t reads the state that includes token t,
    as :func:`_ssd_step`'s does), where ``h_k`` is the state entering the
    chunk; chunk k adds ``Σ_s e^seg[L,s] dt_s x_s ⊗ B_s`` to ``e^cum_L
    h_k``, and the states entering the chunks are those adds carried by
    the chunks' total decays (:func:`_decays` over the chunks)."""
    la = (dt * -a).permute(0, 1, 3, 2)                        # (B, K, H, L)
    decay = _decays(la)                                       # [t, s]
    cum = la.cumsum(-1)
    dtx = (dt[..., None] * xh).transpose(2, 3)                # (B, K, H, L, P)
    y = ((Cc @ Bc.transpose(2, 3))[:, :, None] * decay) @ dtx
    adds = (decay[..., -1, :, None] * dtx).transpose(3, 4) @ Bc[:, :, None]
    # the states entering chunks 0..K-1 and the last: h and the chunks'
    # adds, each carried by the total decays of the chunks after it
    B, K, H, P, N = adds.shape
    carry = _decays(F.pad(cum[..., -1].transpose(1, 2), (1, 0)))
    states = (carry @ torch.cat([h[:, None], adds], 1).reshape(
        B, K + 1, H, P * N).transpose(1, 2)).reshape(B, H, K + 1, P, N)
    y = y + (Cc[:, :, None] @ states[:, :, :K].transpose(1, 2).transpose(
        3, 4)) * cum.exp()[..., None]
    return y.transpose(2, 3) + d_skip[:, None] * xh, states[:, :, K]


def _scan(h, xh, Bf, Cf, dt, a, d_skip):
    """The SSM recurrence over the tokens: (y (B, T, H, P), last state). T
    = 1 (a decode step) is one :func:`_ssd_step`. Else chunks of ``CHUNK``
    tokens (one of T below it; above it the tokens padded to a multiple of
    it with dt = x = B = C = 0, which leave the state and the real tokens'
    outputs exactly as they were), ``GROUP`` chunks a
    :func:`_ssd_chunks`, each group from the state the previous one left
    and, under grad, recomputed in the backward: it keeps one state a
    group."""
    B, T, H, P = xh.shape
    if T == 1:
        h, y = _ssd_step(h, xh[:, 0], Bf[:, 0], Cf[:, 0], dt[:, 0], a,
                         d_skip)
        return y[:, None], h
    L = min(T, CHUNK)
    pad = -T % L
    chunks = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)).reshape(
        B, (T + pad) // L, L, *t.shape[2:])
    xh, Bf, Cf, dt = map(chunks, (xh, Bf, Cf, dt))
    group = checkpointed(_ssd_chunks) if torch.is_grad_enabled() \
        else _ssd_chunks
    ys = []
    for k in range(0, xh.shape[1], GROUP):
        part = slice(k, k + GROUP)
        y, h = group(h, xh[:, part], Bf[:, part], Cf[:, part], dt[:, part],
                     a, d_skip)
        ys.append(y)
    return torch.cat(ys, 1).reshape(B, T + pad, H, P)[:, :T], h


def mamba_block(p: MambaParams, x: torch.Tensor, *, d_state: int,
                expand: int = 2, head_dim: int = 64,
                state: MambaState | None = None, state_out: bool = True
                ) -> tuple[torch.Tensor, MambaState | None]:
    """x: (B, T, d) -> (out, new state). ``state`` None starts from zeros;
    the new state is returned (None without ``state_out``), the caller
    writes it where it keeps it. Tensor-parallel (:func:`tp_extent` above
    1) the SSM state, read and returned, holds this rank's heads; the conv
    state is whole."""
    d = x.shape[-1]
    d_inner, n_heads = dims(d, d_state, expand=expand, head_dim=head_dim)
    tp = tp_extent(p, n_heads)
    if tp > 1:
        return _mamba_tp(p, x, tp, d_state=d_state, d_inner=d_inner,
                         n_heads=n_heads, head_dim=head_dim, state=state,
                         state_out=state_out)
    p = MambaParams(*(cm.model_whole(t, partial=False) for t in p))
    B, T, d = x.shape
    proj = cm.dense(x, p.w_in)
    z, xbc, dt_raw = torch.split(
        proj, [d_inner, d_inner + 2 * d_state, n_heads], dim=-1)
    if state is None:
        state = init_state(B, d, d_state, expand=expand, head_dim=head_dim,
                           dtype=x.dtype, device=x.device)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b, state.conv)
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())      # (B, T, H)
    a = torch.exp(p.a_log.float())                            # (H,)
    xh = xs.float().reshape(B, T, n_heads, head_dim)
    y, h = _scan(state.ssm, xh, Bmat.float(), Cmat.float(), dt, a,
                 p.d_skip.float())
    y = y.reshape(B, T, d_inner)
    # gated RMSNorm (Mamba-2): norm(y * silu(z))
    y = y * F.silu(z.float())
    y = cm.rms_norm(y.to(x.dtype), p.norm_g)
    return cm.dense(y, p.w_out), MambaState(ssm=h, conv=conv_state) \
        if state_out else None


def _mamba_tp(p: MambaParams, x, tp: int, *, d_state, d_inner, n_heads,
              head_dim, state, state_out, eps: float = 1e-5):
    """:func:`mamba_block` on this rank's ``n_heads / tp`` heads."""
    B, T, _ = x.shape
    mesh = cm.tp_mesh()
    r = mesh.axis_index("model")
    H, dl, N = n_heads // tp, d_inner // tp, d_state
    at = lambda lo, n: torch.arange(lo, lo + n, device=x.device)
    # its input columns: z and x of this rank's heads, B and C, dt of its
    # heads
    xbc_cols = torch.cat([at(d_inner + r * dl, dl), at(2 * d_inner, 2 * N)])
    cols = torch.cat([at(r * dl, dl), xbc_cols,
                      at(2 * d_inner + 2 * N + r * H, H)])
    # the conv's whole leaves, whose channels feed this rank's heads only:
    # their gradients are summed over 'model' (B's and C's are partial)
    whole = lambda t: cm.model_whole(t, partial=True)
    conv_cols = xbc_cols - d_inner
    # the product of this rank's stored block of w_in, the blocks' outputs
    # gathered (each rank reads its own columns of them)
    proj = cd.gather_from_model(cd.column_parallel(x, p.w_in, mesh=mesh),
                                mesh, -1, sum_grad=True).index_select(-1, cols)
    z, xbc, dt_raw = torch.split(proj, [dl, dl + 2 * N, H], dim=-1)
    if state is None:
        prefix = torch.zeros((B, CONV_K - 1, dl + 2 * N), dtype=x.dtype,
                             device=x.device)
        h0 = torch.zeros((B, H, head_dim, N), dtype=torch.float32,
                         device=x.device)
    else:
        prefix, h0 = state.conv.index_select(-1, conv_cols), state.ssm
        if tuple(h0.shape[1:]) != (H, head_dim, N):
            raise ValueError(f"an SSM state of {tuple(h0.shape)} for {H} "
                             f"heads of {head_dim} a rank")
    xbc, tail = _causal_conv(xbc, whole(p.conv_w).index_select(-1, conv_cols),
                             whole(p.conv_b).index_select(-1, conv_cols),
                             prefix)
    xs, Bmat, Cmat = torch.split(xbc, [dl, N, N], dim=-1)
    heads = lambda t: cd.scatter_to_model(t, mesh, 0).float()
    dt = F.softplus(dt_raw.float() + heads(p.dt_bias))        # (B, T, H)
    y, h = _scan(h0, xs.float().reshape(B, T, H, head_dim), Bmat.float(),
                 Cmat.float(), dt, torch.exp(heads(p.a_log)),
                 heads(p.d_skip))
    # gated RMSNorm over the whole d_inner: the local f32 sum of squares
    # summed over 'model' (then consumed by this rank's heads alone, so its
    # gradient is summed back: copy_to_model)
    y32 = (y.reshape(B, T, dl) * F.silu(z.float())).to(x.dtype).float()
    ss = cd.copy_to_model(cd.reduce_from_model(
        (y32 * y32).sum(-1, keepdim=True), mesh), mesh)
    y = (y32 * torch.rsqrt(ss / d_inner + eps) * p.norm_g.float()).to(
        x.dtype)
    out = cd.row_parallel(y, p.w_out, mesh=mesh, out_dtype=x.dtype)
    if not state_out:
        return out, None
    # the conv state whole on every rank: the ranks' x channels gathered
    conv = torch.cat([cd.gather_from_model(tail[..., :dl].contiguous(), mesh,
                                           -1), tail[..., dl:]], dim=-1)
    return out, MambaState(ssm=h, conv=conv)
