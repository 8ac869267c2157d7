"""GQA self-attention for training, prefill and decode, with a contiguous
KV cache (static batching and the engine's per-slot lanes) or a paged
block pool (port of ``repro/layers/attention.py:26-582``).

Attention itself stays in plain torch ops, as the reference keeps it in
plain XLA code (no Pallas kernel); the q/k/v/o projections route through
:func:`repro_torch.layers.common.dense`. Scores and softmax run in f32
(``NEG_INF`` masking) on operands rounded to the activation dtype at the
same places as the reference.

Every position is a device tensor (the cache length, a chunk's start and
true length, a slot) and every cache write is an in-place scatter with
tensor indices: a decode step or prefill chunk captured once as a CUDA
graph replays at any position, and nothing in it reads a value back to
the host. JAX drops an out-of-range scatter index (``mode="drop"``);
PyTorch raises on the CPU and faults on the card, so each write here
keeps its indices in range by construction and says how.
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
    ``q * jnp.asarray(scale, q.dtype)`` does. The scale is a 0-d CPU
    tensor, which torch passes to a CUDA kernel as an argument: no copy to
    the card, so the product can be captured in a CUDA graph."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)


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
    # valid prefix length, int32 on the cache's device: 0-d (static
    # batching, one position for every row) or (B,) (per-slot positions,
    # the engine's lanes, each decoding at its own depth)
    length: torch.Tensor


def init_kv_cache(batch, max_len, n_kv_heads, head_dim,
                  dtype=torch.bfloat16, *, device) -> KVCache:
    shape = (batch, max_len, n_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def prefill_attention(p: AttnParams, x: torch.Tensor, cache: KVCache, *,
                      rope_theta: float = 10000.0, chunk: int | None = 1024
                      ) -> tuple[torch.Tensor, KVCache]:
    """Prefill: full self-attention + write the KV cache prefix in place
    (the counterpart of the reference's donated ``dynamic_update_slice``).
    The caller sets the length (``lm.prefill``)."""
    B, S, _ = x.shape
    n_kv, hd = cache.k.shape[2], cache.k.shape[3]
    q, k, v = _qkv_rotary(p, x, n_kv, hd,
                          torch.arange(S, device=x.device)[None, :],
                          rope_theta)
    cache.k[:, :S] = k
    cache.v[:, :S] = v
    n_heads = q.shape[2]
    kr = _repeat_kv(k, n_heads // n_kv)
    vr = _repeat_kv(v, n_heads // n_kv)
    o = attention_core(q, kr, vr, causal=True, chunk=chunk)
    return cm.dense(o.reshape(B, S, -1), p.wo), cache


def _decode_contract(p: AttnParams, q, x, gk, gv, valid) -> torch.Tensor:
    """The masked single-query contraction of every decode path: q
    (B, 1, H, Dh) against the (B, S, Hkv, Dh) keys and values in the
    cache's storage dtype, accumulated in f32; ``valid`` (B, S)."""
    B = x.shape[0]
    n_heads, n_kv = q.shape[2], gk.shape[2]
    kr = _repeat_kv(gk, n_heads // n_kv)
    vr = _repeat_kv(gv, n_heads // n_kv)
    s = torch.einsum("bqhd,bkhd->bhqk",
                     _scaled(q).to(kr.dtype).float(), kr.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob.to(vr.dtype).float(), vr.float())
    return cm.dense(o.reshape(B, 1, -1).to(x.dtype), p.wo)


def _qkv_rotary(p: AttnParams, x, n_kv: int, hd: int, positions,
                rope_theta: float):
    """q, k, v of x (B, S, d) with rotary at ``positions`` (B or 1, S)."""
    B, S, _ = x.shape
    q = cm.dense(x, p.wq, p.bq).reshape(B, S, -1, hd)
    k = cm.dense(x, p.wk, p.bk).reshape(B, S, n_kv, hd)
    v = cm.dense(x, p.wv, p.bv).reshape(B, S, n_kv, hd)
    sin, cos = cm.rotary_embedding(positions, hd, rope_theta)
    return cm.apply_rotary(q, sin, cos), cm.apply_rotary(k, sin, cos), v


def decode_attention(p: AttnParams, x: torch.Tensor, cache: KVCache, *,
                     rope_theta: float = 10000.0
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: x (B, 1, d) against the cache; the new K/V are
    written in place at ``cache.length``.

    A 0-d length puts every row at one position (static batching); a (B,)
    length is per slot (the engine's lanes). The caller advances the
    length (``lm.decode_step``, by the active lanes). A vacant lane may sit
    at ``length == S_max``, where the reference's ``mode="drop"`` scatter
    writes nothing: here its index is clamped to S_max - 1 and the old
    value written back, so the write is a no-op there too.
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    S_max, n_kv, hd = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    pos = cache.length
    per_slot = pos.dim() == 1
    q, k, v = _qkv_rotary(p, x, n_kv, hd,
                          pos[:, None] if per_slot else pos.reshape(1, 1),
                          rope_theta)
    kpos = torch.arange(S_max, device=x.device)
    if per_slot:
        rows = torch.arange(B, device=x.device)
        at = pos.clamp(max=S_max - 1)
        keep = (pos >= S_max)[:, None, None]
        for c, new in ((cache.k, k), (cache.v, v)):
            c[rows, at] = torch.where(keep, c[rows, at], new[:, 0])
        valid = kpos[None, :] <= pos[:, None]
    else:
        at = pos.reshape(1).long()
        cache.k.index_copy_(1, at, k)
        cache.v.index_copy_(1, at, v)
        valid = (kpos <= pos).expand(B, S_max)
    return _decode_contract(p, q, x, cache.k, cache.v, valid), cache


class PagedKVCache(NamedTuple):
    """Block-pool KV cache (port of the reference's ``PagedKVCache``, in the
    activation dtype: the int8 pool and its scales are ROADMAP queue 1,
    item 6).

    K/V live in a flat pool of fixed-size token blocks shared by every slot
    lane; a per-slot block table maps logical positions to pool blocks.
    Block 0 is the null block: vacant table entries point at it and
    redirected (inactive-lane, pad-position) writes land in it, so every
    write index is in range and every value a gather reads is finite;
    invalid positions are masked to ``NEG_INF`` before softmax.
    """

    k: torch.Tensor        # (num_blocks, block_size, Hkv, Dh) [(L, ...)]
    v: torch.Tensor
    table: torch.Tensor    # (num_slots, max_blocks) int32 pool-block ids
    length: torch.Tensor   # (num_slots,) int32 tokens written per slot


def init_paged_kv_cache(num_slots, num_blocks, block_size, max_blocks,
                        n_kv_heads, head_dim, dtype=torch.bfloat16, *,
                        device) -> PagedKVCache:
    shape = (num_blocks, block_size, n_kv_heads, head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        table=torch.zeros((num_slots, max_blocks), dtype=torch.int32,
                          device=device),
        length=torch.zeros((num_slots,), dtype=torch.int32, device=device))


def paged_prefill_attention(p: AttnParams, x: torch.Tensor,
                            cache: PagedKVCache, *, slot, start, true_len,
                            rope_theta: float = 10000.0
                            ) -> tuple[torch.Tensor, PagedKVCache]:
    """One prefill chunk for the request in lane ``slot`` (0-d int
    tensors: ``slot``, ``start`` = prompt tokens earlier chunks wrote,
    ``true_len`` <= C = real tokens of this chunk).

    ``x`` is (1, C, d), right-padded to the bucket C. The chunk's K/V
    scatter into the slot's blocks at positions start..start+true_len-1;
    pad positions go to (null block, offset 0), and the table index is
    clamped to the table, so no index leaves the pool. Queries then attend
    causally to the slot's whole written prefix through the block table.
    """
    B, C, _ = x.shape
    if B != 1:
        raise ValueError(f"a prefill chunk is one request, got {B} rows")
    bs, n_kv, hd = cache.k.shape[1:]
    mb = cache.table.shape[1]
    ar = torch.arange(C, device=x.device)
    pos = start + ar
    q, k, v = _qkv_rotary(p, x, n_kv, hd, pos[None, :], rope_theta)
    valid = ar < true_len
    # (max_blocks,); indexing with the 0-d tensor itself would read it back
    row = cache.table.index_select(0, slot.reshape(1))[0]
    blk = torch.where(valid, row[torch.clamp(pos // bs, max=mb - 1)], 0)
    off = torch.where(valid, pos % bs, 0)
    cache.k[blk, off] = k[0]
    cache.v[blk, off] = v[0]
    kr = cache.k[row].reshape(1, mb * bs, n_kv, hd)
    vr = cache.v[row].reshape(1, mb * bs, n_kv, hd)
    n_heads = q.shape[2]
    kr = _repeat_kv(kr, n_heads // n_kv)
    vr = _repeat_kv(vr, n_heads // n_kv)
    s = torch.einsum("bqhd,bkhd->bhqk", _scaled(q).float(),
                     kr.to(q.dtype).float())
    kpos = torch.arange(mb * bs, device=x.device)
    s = torch.where((kpos[None, :] <= pos[:, None])[None, None], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob.to(vr.dtype).float(),
                     vr.float()).to(q.dtype)
    return cm.dense(o.reshape(B, C, -1), p.wo), cache


def paged_decode_attention(p: AttnParams, x: torch.Tensor,
                           cache: PagedKVCache, *,
                           rope_theta: float = 10000.0,
                           active: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step against the block pool: the contraction of the
    contiguous per-slot :func:`decode_attention` over the same logical
    positions, gathered through the table.

    ``active`` (num_slots,) marks live lanes; an inactive lane's write goes
    to the null block (its table row may name blocks the allocator gave to
    another request). The table index is clamped to the table, as the
    reference's is. The caller advances the length.
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    bs, n_kv, hd = cache.k.shape[1:]
    mb = cache.table.shape[1]
    pos = cache.length                                      # (B,)
    q, k, v = _qkv_rotary(p, x, n_kv, hd, pos[:, None], rope_theta)
    rows = torch.arange(B, device=x.device)
    blk = cache.table[rows, torch.clamp(pos // bs, max=mb - 1)]
    if active is not None:
        blk = torch.where(active.bool(), blk, 0)            # null-block spill
    cache.k[blk, pos % bs] = k[:, 0]
    cache.v[blk, pos % bs] = v[:, 0]
    gk = cache.k[cache.table].reshape(B, mb * bs, n_kv, hd)
    gv = cache.v[cache.table].reshape(B, mb * bs, n_kv, hd)
    kpos = torch.arange(mb * bs, device=x.device)
    valid = kpos[None, :] <= pos[:, None]
    return _decode_contract(p, q, x, gk, gv, valid), cache
