"""Mamba-2 (SSD) block of the zamba2 hybrid family (port of
``repro.layers.mamba``).

The in and out projections are GEMMs through :func:`cm.dense` (the fat
GEMM and GEMV kernels). The depthwise causal conv and the SSM state update
(a per-head outer-product recurrence, state ``head_dim x d_state`` in f32)
are torch ops: the reference runs them as jnp code and a ``lax.scan``, not
as a Pallas kernel. The scan is a Python loop over the tokens, one
:func:`_ssd_step` each; the reference's chunked, checkpointed branch (``T %
64 == 0 and T > 64``) bounds backward storage and computes the same
forward, so one loop serves every T.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.layers import common as cm

CONV_K = 4  # depthwise causal conv width


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


def mamba_block(p: MambaParams, x: torch.Tensor, *, d_state: int,
                expand: int = 2, head_dim: int = 64,
                state: MambaState | None = None
                ) -> tuple[torch.Tensor, MambaState]:
    """x: (B, T, d) -> (out, new state). ``state`` None starts from zeros;
    the new state is returned, the caller writes it where it keeps it."""
    B, T, d = x.shape
    d_inner, n_heads = dims(d, d_state, expand=expand, head_dim=head_dim)
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
    d_skip = p.d_skip.float()
    xh = xs.float().reshape(B, T, n_heads, head_dim)
    Bf, Cf = Bmat.float(), Cmat.float()
    h, ys = state.ssm, []
    for t in range(T):
        h, y = _ssd_step(h, xh[:, t], Bf[:, t], Cf[:, t], dt[:, t], a,
                         d_skip)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, T, d_inner)
    # gated RMSNorm (Mamba-2): norm(y * silu(z))
    y = y * F.silu(z.float())
    y = cm.rms_norm(y.to(x.dtype), p.norm_g)
    return cm.dense(y, p.w_out), MambaState(ssm=h, conv=conv_state)
