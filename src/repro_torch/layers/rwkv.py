"""RWKV-6 "Finch" block (port of ``repro.layers.rwkv``): time-mix with
data-dependent decay, and channel-mix.

The projections (R, K, V, G, O, the LoRA towers, channel-mix) route through
:func:`repro_torch.layers.common.dense`, the balanced-GEMM substrate. The
WKV recurrence follows the reference's branch rule: a sequence with
``T % 32 == 0 and T > 32`` takes the chunk-parallel form, launched as the
hand-written kernel ``kernels/csrc/wkv.cu`` through
:func:`repro_torch.kernels.wkv.wkv_heads`, which reads the (B, T, H, N)
projections in place (its plain version on a CPU tensor is
:func:`wkv_chunk_parallel` below); any other length, decode included, runs
the token scan :func:`_wkv_step` in plain torch ops, as the reference keeps
it in XLA code.

dtypes follow the reference: the LoRA up-projection and the mixing
coefficients are cast to the activation dtype before use, the decay is
``w0`` (f32) plus a dense output rounded to the activation dtype first, and
the recurrence and the per-head group norm run in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import wkv as wkv_kernel
from repro_torch.layers import common as cm

LORA_R = 32
CHUNK = wkv_kernel.CHUNK


class RwkvTimeMixParams(NamedTuple):
    mu: torch.Tensor        # (5, d) token-shift mixing for (w, k, v, r, g)
    lora_a: torch.Tensor    # (d, 5*LORA_R) data-dependent mix tower (down)
    lora_b: torch.Tensor    # (5, LORA_R, d) data-dependent mix tower (up)
    w0: torch.Tensor        # (d,) decay base
    w_lora_a: torch.Tensor  # (d, LORA_R)
    w_lora_b: torch.Tensor  # (LORA_R, d)
    u: torch.Tensor         # (d,) bonus
    wr: torch.Tensor        # (d, d)
    wk: torch.Tensor        # (d, d)
    wv: torch.Tensor        # (d, d)
    wg: torch.Tensor        # (d, d)
    wo: torch.Tensor        # (d, d)
    ln_g: torch.Tensor      # (d,) per-head group-norm gamma
    ln_b: torch.Tensor      # (d,)


class RwkvChannelMixParams(NamedTuple):
    mu_k: torch.Tensor      # (d,)
    mu_r: torch.Tensor      # (d,)
    wk: torch.Tensor        # (d, f)
    wv: torch.Tensor        # (f, d)
    wr: torch.Tensor        # (d, d)


def _full(shape, value, dtype, lead, device):
    return torch.full((*lead, *shape), value, dtype=dtype, device=device)


def init_time_mix(gen, d, *, dtype=torch.float32, lead=(),
                  device) -> RwkvTimeMixParams:
    """The reference's constants; ``lead`` prepends the layer axis."""
    w = lambda shape, scale=None: cm.normal_init(
        gen, shape, dtype, scale=scale, lead=lead, device=device)
    full = lambda shape, value: _full(shape, value, dtype, lead, device)
    return RwkvTimeMixParams(
        mu=full((5, d), 0.5),
        lora_a=w((d, 5 * LORA_R), 0.01),
        lora_b=w((5, LORA_R, d), 0.01),
        w0=full((d,), -6.0),
        w_lora_a=w((d, LORA_R), 0.01),
        w_lora_b=w((LORA_R, d), 0.01),
        u=full((d,), 0.0),
        wr=w((d, d)),
        wk=w((d, d)),
        wv=w((d, d)),
        wg=w((d, d)),
        wo=w((d, d)),
        ln_g=full((d,), 1.0),
        ln_b=full((d,), 0.0),
    )


def init_channel_mix(gen, d, f, *, dtype=torch.float32, lead=(),
                     device) -> RwkvChannelMixParams:
    w = lambda shape: cm.normal_init(gen, shape, dtype, lead=lead,
                                     device=device)
    return RwkvChannelMixParams(
        mu_k=_full((d,), 0.5, dtype, lead, device),
        mu_r=_full((d,), 0.5, dtype, lead, device),
        wk=w((d, f)),
        wv=w((f, d)),
        wr=w((d, d)),
    )


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each op rounded to x's dtype: how XLA expands
    ``jax.nn.sigmoid``, so bf16 activations round where the reference's do
    (a fused ``torch.sigmoid`` rounds once and differs in ~30% of bf16
    values)."""
    return 1 / (1 + torch.exp(-x))


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Previous-token values; x_prev supplies the value before position 0."""
    first = torch.zeros_like(x[:, :1]) if x_prev is None else \
        x_prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: RwkvTimeMixParams, x, sx):
    """Finch data-dependent token-shift: 5 mixed inputs (w, k, v, r, g)."""
    low = torch.tanh(cm.dense(x + 0.5 * sx, p.lora_a))
    B, T, _ = low.shape
    low = low.reshape(B, T, 5, LORA_R)
    # the up-projection in the activation dtype, accumulated in f32 and
    # rounded once, as XLA's dot of two such operands
    delta = torch.einsum("btkr,krd->btkd", low.float(),
                         p.lora_b.to(x.dtype).float()).to(x.dtype)
    mix = p.mu.to(x.dtype)[None, None] + delta                # (B,T,5,d)
    return x[:, :, None, :] + sx[:, :, None, :] * mix         # (B,T,5,d)


def wkv_chunk_parallel(r, k, v, wlog, u, state, chunk: int = CHUNK):
    """Chunk-parallel WKV, the plain version of the WKV kernel.

      y_t = (r_t ⊙ D_t) · S0                         (inter-chunk)
          + Σ_{s<t} (Σ_n r_t D_t k_s / D_{s+1}) v_s  (intra, C×C)
          + (r_t·u·k_t) v_t                          (bonus diagonal)
      S' = diag(D_C) S0 + (k ⊙ D_C/D_{s+1})ᵀ v

    with D_t = exp(Σ_{s<t} log w_s); the intra-chunk factors are re-centred
    on the chunk's midpoint so that neither over- nor underflows.

    Shapes: r/k/v/wlog (B,H,T,N) f32 (``wlog`` is the log of the decay),
    u (H,N), state (B,H,N,N). Returns (y (B,H,T,N), new_state). T must be
    a multiple of ``chunk``.
    """
    B, H, T, N = r.shape
    C = chunk
    nc = T // C
    split = lambda t: t.reshape(B, H, nc, C, N)
    rs, ks, vs, wl = split(r), split(k), split(v), split(wlog)
    clog = torch.cumsum(wl, dim=3) - wl            # exclusive cumsum
    cend = clog[..., -1, :] + wl[..., -1, :]       # (B,H,nc,N)
    causal = torch.tril(torch.ones((C, C), dtype=r.dtype, device=r.device),
                        -1)                        # strictly lower
    u_bh = u[None, :, None, :]                     # (1,H,1,N)
    S = state
    ys = []
    for c in range(nc):
        rc, kc, vc = rs[:, :, c], ks[:, :, c], vs[:, :, c]
        cl, wlc, ce = clog[:, :, c], wl[:, :, c], cend[:, :, c]
        y1 = torch.einsum("bhtn,bhnm->bhtm", rc * torch.exp(cl), S)
        mid = cl[..., C // 2, :][..., None, :]
        rDm = rc * torch.exp(cl - mid)
        kinv = kc * torch.exp(torch.clamp(mid - (cl + wlc), max=60.0))
        A = torch.einsum("bhtn,bhsn->bhts", rDm, kinv) * causal
        diag = torch.sum(rc * u_bh * kc, dim=-1)   # bonus term (B,H,C)
        y2 = torch.einsum("bhts,bhsm->bhtm", A, vc) + diag[..., None] * vc
        kdec = kc * torch.exp(
            torch.clamp(ce[..., None, :] - (cl + wlc), max=0.0))
        S = torch.exp(ce)[..., :, None] * S + torch.einsum(
            "bhsn,bhsm->bhnm", kdec, vc)
        ys.append(y1 + y2)
    y = torch.stack(ys, dim=2).reshape(B, H, T, N)
    return y, S


def _wkv_step(state, inputs):
    """state: (B,H,N,N); one recurrence step.

    y_t = (S + diag(u) k v^T)^T r ;  S' = diag(w) S + k v^T
    """
    r, k, v, w, u = inputs  # each (B,H,N)
    kv = k[..., :, None] * v[..., None, :]                  # (B,H,N,N)
    y = torch.einsum("bhnm,bhn->bhm", state + u[..., None] * kv, r)
    new_state = w[..., None] * state + kv
    return new_state, y


def time_mix(
    p: RwkvTimeMixParams, x: torch.Tensor, *, n_heads: int,
    state: torch.Tensor | None = None, x_prev: torch.Tensor | None = None,
    eps: float = 1e-5,
):
    """x: (B,T,d). Returns (out, (new_state, last_x)) for recurrent reuse."""
    B, T, d = x.shape
    H, N = n_heads, d // n_heads
    sx = _token_shift(x, x_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx).unbind(2)

    r = cm.dense(xr, p.wr).reshape(B, T, H, N)
    k = cm.dense(xk, p.wk).reshape(B, T, H, N)
    v = cm.dense(xv, p.wv).reshape(B, T, H, N)
    g = cm.dense(xg, p.wg)
    g = g * _sigmoid(g)  # jax.nn.silu
    # data-dependent decay w_t in (0, 1): exp(-exp(w0 + lora(xw)))
    wlog = p.w0.float() + cm.dense(
        torch.tanh(cm.dense(xw, p.w_lora_a)), p.w_lora_b).float()
    u = p.u.float().reshape(H, N)

    if state is None:
        state = torch.zeros((B, H, N, N), dtype=torch.float32,
                            device=x.device)

    if T % CHUNK == 0 and T > CHUNK:
        # the kernel reads r, k, v and the log decay as (B,T,H,N) where
        # they lie and writes y in that layout: no copy on the card
        log_w = (-torch.exp(wlog)).reshape(B, T, H, N)
        y, new_state = wkv_kernel.wkv_heads(r, k, v, log_w, u, state)
        y = y.reshape(B, T, d)
    else:
        w = torch.exp(-torch.exp(wlog)).reshape(B, T, H, N)
        ub = u.expand(B, H, N)
        new_state, ys = state, []
        for t in range(T):
            new_state, y_t = _wkv_step(new_state, (
                r[:, t].float(), k[:, t].float(), v[:, t].float(), w[:, t],
                ub))
            ys.append(y_t)
        y = torch.stack(ys, dim=1).reshape(B, T, d)
    # per-head group norm (its own eps, not the model's norm_eps)
    yh = y.reshape(B, T, H, N)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    y = yh.reshape(B, T, d) * p.ln_g.float() + p.ln_b.float()
    out = cm.dense(y.to(x.dtype) * g, p.wo)
    return out, (new_state, x[:, -1])


def channel_mix(
    p: RwkvChannelMixParams, x: torch.Tensor,
    x_prev: torch.Tensor | None = None,
):
    sx = _token_shift(x, x_prev) - x
    xk = x + sx * p.mu_k.to(x.dtype)
    xr = x + sx * p.mu_r.to(x.dtype)
    k = cm.dense(xk, p.wk, activation="relu")
    kv = cm.dense(k * k, p.wv)  # squared ReLU
    r = _sigmoid(cm.dense(xr, p.wr))
    return r * kv, x[:, -1]
