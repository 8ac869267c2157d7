"""GQA self-attention for training, prefill and decode with a contiguous KV
cache (port of ``repro/layers/attention.py:26-337``).

Attention itself stays in plain torch ops, as the reference keeps it in
plain XLA code (no Pallas kernel); the q/k/v/o projections route through
:func:`repro_torch.layers.common.dense`. Scores and softmax run in f32
(``NEG_INF`` masking) on operands rounded to the activation dtype at the
same places as the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.layers import common as cm

NEG_INF = -1e30


class AttnParams(NamedTuple):
    wq: torch.Tensor           # (d, H*Dh)
    wk: torch.Tensor           # (d, Hkv*Dh)
    wv: torch.Tensor           # (d, Hkv*Dh)
    wo: torch.Tensor           # (H*Dh, d)
    bq: torch.Tensor | None
    bk: torch.Tensor | None
    bv: torch.Tensor | None


def init_attn(gen, d_model, n_heads, n_kv_heads, head_dim, *, qkv_bias=False,
              dtype=torch.float32, lead=(), device) -> AttnParams:
    """``lead`` prepends stacking dims (the layer axis) to every leaf."""
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
    w = lambda shape: cm.normal_init(gen, shape, dtype, lead=lead,
                                     device=device)
    zeros = lambda n: torch.zeros((*lead, n), dtype=dtype, device=device)
    return AttnParams(
        wq=w((d_model, q_dim)),
        wk=w((d_model, kv_dim)),
        wv=w((d_model, kv_dim)),
        wo=w((q_dim, d_model)),
        bq=zeros(q_dim) if qkv_bias else None,
        bk=zeros(kv_dim) if qkv_bias else None,
        bv=zeros(kv_dim) if qkv_bias else None,
    )


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """q * D**-0.5 with the scale rounded to q's dtype first, as
    ``q * jnp.asarray(scale, q.dtype)`` does."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)
    return q * scale


def plain_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference attention, materializes scores. q: (B,Sq,H,D), k/v (B,Sk,H,D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", _scaled(q).float(), k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                      q_offset: int = 0):
    """Online-softmax attention over KV chunks (flash formulation): never
    more than (B, H, Sq, chunk) scores at once."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf = _scaled(q).float()
    qpos = torch.arange(Sq, device=q.device) + q_offset
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        kpos = start + torch.arange(s.shape[-1], device=q.device)
        if causal:
            s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                            NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vb.float())
        m = m_new
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.transpose(1, 2).to(q.dtype)


def attention_core(q, k, v, *, causal: bool, chunk: int | None,
                   q_offset: int = 0):
    if chunk is not None and k.shape[1] > chunk:
        return chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                 q_offset=q_offset)
    return plain_attention(q, k, v, causal=causal, q_offset=q_offset)


def self_attention(
    p: AttnParams,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float = 10000.0,
    chunk: int | None = 1024,
) -> torch.Tensor:
    """Full-sequence causal GQA self-attention (forward without cache)."""
    B, S, _ = x.shape
    q = cm.dense(x, p.wq, p.bq).reshape(B, S, n_heads, head_dim)
    k = cm.dense(x, p.wk, p.bk).reshape(B, S, n_kv_heads, head_dim)
    v = cm.dense(x, p.wv, p.bv).reshape(B, S, n_kv_heads, head_dim)
    sin, cos = cm.rotary_embedding(torch.arange(S, device=x.device)[None, :],
                                   head_dim, rope_theta)
    q = cm.apply_rotary(q, sin, cos)
    k = cm.apply_rotary(k, sin, cos)
    k = _repeat_kv(k, n_heads // n_kv_heads)
    v = _repeat_kv(v, n_heads // n_kv_heads)
    o = attention_core(q, k, v, causal=True, chunk=chunk)
    return cm.dense(o.reshape(B, S, n_heads * head_dim), p.wo)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, Hkv, Dh), or stacked (L, B, S_max, Hkv, Dh)
    v: torch.Tensor
    # valid prefix length: one position for every row (static batching)
    length: int


def prefill_attention(p: AttnParams, x: torch.Tensor, cache: KVCache, *,
                      rope_theta: float = 10000.0, chunk: int | None = 1024
                      ) -> tuple[torch.Tensor, KVCache]:
    """Prefill: full self-attention + write the KV cache prefix in place
    (the counterpart of the reference's donated ``dynamic_update_slice``)."""
    B, S, _ = x.shape
    n_kv, hd = cache.k.shape[2], cache.k.shape[3]
    q = cm.dense(x, p.wq, p.bq).reshape(B, S, -1, hd)
    k = cm.dense(x, p.wk, p.bk).reshape(B, S, n_kv, hd)
    v = cm.dense(x, p.wv, p.bv).reshape(B, S, n_kv, hd)
    sin, cos = cm.rotary_embedding(torch.arange(S, device=x.device)[None, :],
                                   hd, rope_theta)
    q = cm.apply_rotary(q, sin, cos)
    k = cm.apply_rotary(k, sin, cos)
    cache.k[:, :S] = k
    cache.v[:, :S] = v
    n_heads = q.shape[2]
    kr = _repeat_kv(k, n_heads // n_kv)
    vr = _repeat_kv(v, n_heads // n_kv)
    o = attention_core(q, kr, vr, causal=True, chunk=chunk)
    return cm.dense(o.reshape(B, S, -1), p.wo), KVCache(cache.k, cache.v, S)


def decode_attention(p: AttnParams, x: torch.Tensor, cache: KVCache, *,
                     rope_theta: float = 10000.0
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: x (B, 1, d) against the cache; the new K/V are
    written in place at position ``cache.length``."""
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    n_kv, hd = cache.k.shape[2], cache.k.shape[3]
    q = cm.dense(x, p.wq, p.bq).reshape(B, 1, -1, hd)
    k = cm.dense(x, p.wk, p.bk).reshape(B, 1, n_kv, hd)
    v = cm.dense(x, p.wv, p.bv).reshape(B, 1, n_kv, hd)
    pos = cache.length
    sin, cos = cm.rotary_embedding(torch.full((1, 1), pos, device=x.device),
                                   hd, rope_theta)
    q = cm.apply_rotary(q, sin, cos)
    k = cm.apply_rotary(k, sin, cos)
    cache.k[:, pos] = k[:, 0]
    cache.v[:, pos] = v[:, 0]
    n_heads = q.shape[2]
    kr = _repeat_kv(cache.k, n_heads // n_kv)
    vr = _repeat_kv(cache.v, n_heads // n_kv)
    # contract in the cache's storage dtype, accumulate in f32
    s = torch.einsum("bqhd,bkhd->bhqk",
                     _scaled(q).to(kr.dtype).float(), kr.float())
    valid = torch.arange(cache.k.shape[1], device=x.device) <= pos
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob.to(vr.dtype).float(), vr.float())
    out = cm.dense(o.reshape(B, 1, -1).to(x.dtype), p.wo)
    return out, KVCache(cache.k, cache.v, pos + 1)
