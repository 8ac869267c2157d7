"""GQA self-attention for training, prefill and decode, with a contiguous
KV cache (static batching and the engine's per-slot lanes) or a paged
block pool, the speculative verify pass over it, and cross-attention
(port of ``repro/layers/attention.py``).

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

Under a sharded plan with 'model' above 1 (``parallel.fsdp.ShardPlan``)
full-sequence attention, prefill, the contiguous decode and the paged
prefill chunk, decode tick and verify pass are tensor-parallel
(:func:`_attend_full`, :func:`decode_attention`, :func:`_paged_attention`):
a cache or pool holds this rank's kv heads, or its head_dim block where the
kv heads do not divide 'model' (``decode_state_specs``). Where neither
does, a contiguous cache holds this rank's block of the sequence (where
'model' divides it: each rank writes the positions it holds and attends
over them, the softmax normalized over 'model') or the whole
cache, and a pool stays whole on every rank. An int8 pool's
scales follow its kv heads, or stay whole on every rank of a head_dim
pool, whose quantizer takes each block's absmax over 'model'
(:func:`_pool_reduce`). W8A8 projections run through
``core.distributed``'s column- and row-parallel products; in 'seq' mode
their activation scale spans 'model' too (the rows are split over it).

Over the DP axes (a plan whose ``kv`` names the decode state's layout) a
step's rows may be this rank's lanes, and the cache this rank's block of
the lanes, of the sequence (a contiguous cache whose lanes DP does not
divide) or of a pool's blocks; the lengths and the block table stay whole
on every rank. A lane-split step all-gathers its new K/V rows over DP and
each rank writes the rows whose block it holds (:func:`_pool_write`'s
last-row rule over the whole rows, so the bytes are the one-device
pool's). A split pool's gather reads the blocks held here, zeros for the
others, and sums over DP on the raw bytes (one nonzero plus zeros is
exact): reduce-scattered by lanes where the lanes are split, all-reduced
where they are not. A sequence-split cache writes the position it holds
and all-gathers the sequence before the contraction.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import distributed as cd
from repro_torch.core.context import current_context
from repro_torch.layers import common as cm
from repro_torch.quant import int8 as q8
from repro_torch.quant.kvcache import KVCacheDtype

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


def attn_axes(qkv_bias=False) -> AttnParams:
    """Logical sharding axes mirroring AttnParams (the reference's)."""
    return AttnParams(
        wq=("embed", "heads"), wk=("embed", "kv"), wv=("embed", "kv"),
        wo=("heads", "embed"),
        bq=("heads",) if qkv_bias else None,
        bk=("kv",) if qkv_bias else None,
        bv=("kv",) if qkv_bias else None,
    )


def _attn_mode(n_heads: int, seq: int) -> str:
    """How the reference parallelizes attention activations over the
    'model' axis of the active context's mesh: 'heads' (heads divide it),
    'seq' (context parallelism: the query sequence divides it) or 'none'
    (no such axis, or tiny shapes)."""
    tp = cm.axis_size("model")
    if tp <= 1:
        return "none"
    if n_heads % tp == 0:
        return "heads"
    if seq % tp == 0:
        return "seq"
    return "none"


def _tp_mode(p: AttnParams, n_heads: int, seq: int) -> str:
    """:func:`_attn_mode` under a tensor-parallel plan ('none' without
    one). 'heads' needs ``wq`` and ``wo`` as this rank's head blocks."""
    tp = cm.tp_size()
    if tp == 1:
        return "none"
    mode = _attn_mode(n_heads, seq)
    if mode == "heads" and (cm.block_dim(p.wq) != 1
                            or cm.block_dim(p.wo) != 0):
        mode = "seq" if seq % tp == 0 else "none"
    return mode


def _whole(p: AttnParams, partial: bool) -> AttnParams:
    """Every leaf of ``p`` whole over 'model' (``cm.model_whole``)."""
    return AttnParams(*(cm.model_whole(t, partial=partial) for t in p))


def _rope(q, k, positions, hd: int, theta: float):
    sin, cos = cm.rotary_embedding(positions, hd, theta)
    return cm.apply_rotary(q, sin, cos), cm.apply_rotary(k, sin, cos)


def _proj_whole(xin, w, b, mesh):
    """``xin @ w + b`` of every column from ``xin`` (already through
    ``copy_to_model``): a column block's output gathered over 'model' (its
    gradient summed: each rank reads its own columns of it), or a whole
    weight's product (its gradient summed over 'model')."""
    if cm.block_dim(w) is not None:
        return cd.gather_from_model(cd.local_gemm(xin, w, b), mesh, -1,
                                    sum_grad=True)
    return cd.local_gemm(xin, cm.model_whole(w, partial=True),
                         cm.model_whole(b, partial=True))


def _expand(q, k, v, idx):
    """k and v per query head: repeated (GQA), or the kv head ``idx[j]``
    for local query head j."""
    if idx is None:
        rep = q.shape[2] // k.shape[2]
        return _repeat_kv(k, rep), _repeat_kv(v, rep)
    return k.index_select(2, idx), v.index_select(2, idx)


def _attend_full(p: AttnParams, x, src, *, n_heads: int, n_kv: int,
                 hd: int, causal: bool, chunk, positions, rope_theta: float):
    """Attention of ``x`` (B, S, d) over ``src`` (None: self-attention;
    rotary at ``positions`` unless None), the output projection included
    (``n_heads`` may be None without a tensor-parallel plan):
    (y (B, S, d), k, v). k and v are (B, Sk, Hkv', Dh) as computed: this
    rank's kv heads ('heads' mode with kv heads dividing 'model') or every
    kv head (the other cases), rotated.

    Tensor-parallel over 'model' under a sharded plan (:func:`_tp_mode`):

    * 'heads': q of this rank's heads (column-parallel), k and v of its kv
      heads; where the kv heads do not divide 'model' (GQA), k and v of
      every kv head (their column blocks' outputs gathered) and each local
      query head reads its own kv head; ``wo`` row-parallel;
    * 'seq': the leaves gathered whole (their gradients summed over
      'model'), q, k and v of this rank's S/tp rows, k and v gathered along
      S, attention at this rank's causal offset, ``wo`` on its rows, the
      rows gathered along S;
    * 'none': the leaves gathered whole, every rank computes alike.
    """
    B, S, _ = x.shape
    if positions is None and p.bk is not None and p.bk.requires_grad:
        # unrotated keys: the softmax cancels q . b_k, whose gradient is
        # exactly 0 (computed, it is the rounding of a sum that cancels,
        # which Adam's 1 / eps would turn into a step)
        dim = cd.model_block_dim(p.bk)
        bk = p.bk.detach()
        p = p._replace(bk=bk if dim is None else
                       cd.mark_model_block(bk, dim))
    mode = _tp_mode(p, n_heads, S)
    if mode == "heads":
        return _heads_attention(p, x, src, n_heads=n_heads, n_kv=n_kv, hd=hd,
                                causal=causal, chunk=chunk,
                                positions=positions, rope_theta=rope_theta)
    if mode == "seq":
        return _seq_attention(p, x, src, n_kv=n_kv, hd=hd, causal=causal,
                              chunk=chunk, positions=positions,
                              rope_theta=rope_theta)
    p = _whole(p, partial=False)
    kv_in = x if src is None else src
    Sk = kv_in.shape[1]
    q = cm.dense(x, p.wq, p.bq).reshape(B, S, -1, hd)
    k = cm.dense(kv_in, p.wk, p.bk).reshape(B, Sk, n_kv, hd)
    v = cm.dense(kv_in, p.wv, p.bv).reshape(B, Sk, n_kv, hd)
    if positions is not None:
        q, k = _rope(q, k, positions, hd, rope_theta)
    kr, vr = _expand(q, k, v, None)
    o = attention_core(q, kr, vr, causal=causal, chunk=chunk)
    return cm.dense(o.reshape(B, S, -1), p.wo), k, v


def _heads_attention(p, x, src, *, n_heads, n_kv, hd, causal, chunk,
                     positions, rope_theta):
    mesh = cm.tp_mesh()
    tp, r = mesh.axis_size("model"), mesh.axis_index("model")
    B, S, _ = x.shape
    xin = cd.copy_to_model(x, mesh)
    kv_in = xin if src is None else cd.copy_to_model(src, mesh)
    Sk = kv_in.shape[1]
    q = cd.local_gemm(xin, p.wq, p.bq).reshape(B, S, -1, hd)
    if n_kv % tp == 0 and cm.block_dim(p.wk) == 1:
        k = cd.local_gemm(kv_in, p.wk, p.bk).reshape(B, Sk, -1, hd)
        v = cd.local_gemm(kv_in, p.wv, p.bv).reshape(B, Sk, -1, hd)
        idx = None
    else:  # GQA: a column block of wk may split a kv head
        k = _proj_whole(kv_in, p.wk, p.bk, mesh).reshape(B, Sk, n_kv, hd)
        v = _proj_whole(kv_in, p.wv, p.bv, mesh).reshape(B, Sk, n_kv, hd)
        hq = n_heads // tp
        idx = torch.arange(r * hq, (r + 1) * hq,
                           device=x.device) // (n_heads // n_kv)
    if positions is not None:
        q, k = _rope(q, k, positions, hd, rope_theta)
    kr, vr = _expand(q, k, v, idx)
    o = attention_core(q, kr, vr, causal=causal, chunk=chunk)
    y = cd.row_parallel(o.reshape(B, S, -1), p.wo, mesh=mesh,
                        out_dtype=x.dtype)
    return y, k, v


def _seq_attention(p, x, src, *, n_kv, hd, causal, chunk, positions,
                   rope_theta):
    mesh = cm.tp_mesh()
    tp, r = mesh.axis_size("model"), mesh.axis_index("model")
    B, S, _ = x.shape
    n = S // tp
    off = r * n
    pw = _whole(p, partial=True)
    xr = cd.scatter_to_model(x, mesh, 1)
    # this rank's rows: a W8A8 scale spans 'model' too
    rows_of = dict(split=("model",))
    q = cd.local_gemm(xr, pw.wq, pw.bq, **rows_of).reshape(B, n, -1, hd)
    if src is None or src.shape[1] % tp == 0:
        # k and v of this rank's rows, gathered along the sequence
        rows = xr if src is None else cd.scatter_to_model(src, mesh, 1)
        m = rows.shape[1]
        k = cd.local_gemm(rows, pw.wk, pw.bk, **rows_of).reshape(
            B, m, n_kv, hd)
        v = cd.local_gemm(rows, pw.wv, pw.bv, **rows_of).reshape(
            B, m, n_kv, hd)
        if positions is not None:
            q, k = _rope(q, k, positions[:, off:off + n], hd, rope_theta)
        k = cd.gather_from_model(k, mesh, 1, sum_grad=True)
        v = cd.gather_from_model(v, mesh, 1, sum_grad=True)
    else:  # a source whose length 'model' does not divide: whole
        whole = cd.copy_to_model(src, mesh)
        Sk = whole.shape[1]
        k = cd.local_gemm(whole, pw.wk, pw.bk).reshape(B, Sk, n_kv, hd)
        v = cd.local_gemm(whole, pw.wv, pw.bv).reshape(B, Sk, n_kv, hd)
    kr, vr = _expand(q, k, v, None)
    o = attention_core(q, kr, vr, causal=causal, chunk=chunk, q_offset=off)
    y = cd.local_gemm(o.reshape(B, n, -1), pw.wo, **rows_of)
    return cd.gather_from_model(y, mesh, 1), k, v


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
    causal: bool = True,
    chunk: int | None = 1024,
    positions: torch.Tensor | None = None,
    use_rope: bool = True,
) -> torch.Tensor:
    """Full-sequence GQA self-attention (forward without cache).
    ``positions`` (B or 1, S) default to 0..S-1; ``use_rope=False`` (the
    encoder-decoder's encoder) leaves q and k unrotated. Tensor-parallel
    under a sharded plan (:func:`_attend_full`)."""
    if use_rope and positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _attend_full(p, x, None, n_heads=n_heads, n_kv=n_kv_heads,
                        hd=head_dim, causal=causal, chunk=chunk,
                        positions=positions if use_rope else None,
                        rope_theta=rope_theta)[0]


def cross_attention(
    p: AttnParams,
    x: torch.Tensor,
    kv_src: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    chunk: int | None = None,
) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, d), keys and values from
    ``kv_src`` (B, Sk, d); no rope, no causal mask. Tensor-parallel under a
    sharded plan (:func:`_attend_full`)."""
    return _attend_full(p, x, kv_src, n_heads=n_heads, n_kv=n_kv_heads,
                        hd=head_dim, causal=False, chunk=chunk,
                        positions=None, rope_theta=0.0)[0]


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


def _cache_layout(n_kv: int, hd: int, dp: _DP | None = None) -> str:
    """How a contiguous cache lies over 'model' (``decode_state_specs``):
    'whole' (no tensor-parallel plan, or every rank holds all of it),
    'heads' (the kv heads divide it), 'head_dim' (its head_dim does), or
    'seq' where neither does and ``dp`` (:func:`_over_dp`) holds this
    rank's block of the sequence over 'model' (the reference's sequence
    fallback, where 'model' divides ``max_len``). A pool never takes the
    sequence fallback: it stays whole."""
    tp = cm.tp_size()
    if tp == 1:
        return "whole"
    if n_kv % tp == 0:
        return "heads"
    if hd % tp == 0:
        return "head_dim"
    if dp is not None and dp.held is not None and "model" in cd.entry_axes(
            dp.over):
        return "seq"
    return "whole"


def _cache_block(t, shape, layout: str):
    """This rank's block of k or v (..., Hkv, Dh) as a cache whose trailing
    dims are ``shape`` stores it: ``t`` itself where it already is (this
    rank's kv heads, or a whole cache), else its kv heads' or head_dim's
    block."""
    if tuple(t.shape[-2:]) == tuple(shape):
        return t
    r = cm.tp_mesh().axis_index("model")
    if layout == "heads":
        n = shape[0]
        return t[..., r * n:(r + 1) * n, :]
    n = shape[1]
    return t[..., r * n:(r + 1) * n]


class _DP(NamedTuple):
    """How a step's rows and a decode state lie over the mesh: the lanes
    over the DP axes, and the block held here of a dim split over the DP
    axes (a pool's blocks, a contiguous cache's sequence) or over 'model'
    (a contiguous cache's sequence)."""
    mesh: Any
    entry: Any                         # the DP axes' spec entry
    lanes: slice | None                # this rank's lanes (None: every one)
    held: tuple[int, int] | None       # (first, count) of the split dim
    over: Any                          # the spec entry it is split over


def _over_dp(total: int, rows: int, dim: int, local: int) -> _DP | None:
    """The layout of a step's rows and state under the active plan, or
    None (no plan naming the state's layout, nothing split). A step of
    ``rows`` rows over a state of ``total`` lanes holds this rank's lanes
    where they differ; ``dim`` is the stacked K leaf's dim that may be
    split besides the lanes (-4: a pool's blocks, over DP; -3: a
    contiguous cache's sequence, over DP or 'model'), of which ``local``
    are held here."""
    plan = current_context().shard
    if plan is None or plan.kv is None:
        return None
    mesh = plan.mesh
    entry, _, index = cd.data_parallel(mesh)
    lanes = None if rows == total else slice(index * rows, (index + 1) * rows)
    over = plan.kv[dim]
    held = None
    if cd.axes_extent(mesh, over) > 1:
        held = (cd.entry_index(mesh, over) * local, local)
    if lanes is None and held is None:
        return None
    return _DP(mesh, entry, lanes, held, over)


def _dp_sum(t: torch.Tensor, dp: _DP) -> torch.Tensor:
    """The sum over DP of ``t`` (lanes leading), each element's bytes held
    by one rank and zero on the others: reduce-scattered by lanes where
    they are split, else all-reduced, on the raw bytes (one nonzero plus
    zeros is exact in any dtype)."""
    bits = t.contiguous().view(torch.uint8)
    if dp.lanes is not None:
        bits = cd.reduce_scatter_over(bits, dp.mesh, dp.entry, 0)
    else:
        bits = cd.all_reduce(bits, dp.mesh, cd.entry_axes(dp.entry))
    return bits.view(t.dtype)


def _held(t: torch.Tensor, idx: torch.Tensor, held) -> torch.Tensor:
    """``t[idx]`` for the global ids ``idx`` of ``t``'s split leading dim,
    of which this rank holds ``held`` = (first, count): zeros for the ids
    held elsewhere."""
    lo, n = held
    loc = idx - lo
    own = (loc >= 0) & (loc < n)
    g = t[loc.clamp(0, n - 1)]
    return torch.where(own.reshape(*own.shape, *(1,) * (g.dim() - own.dim())),
                       g, torch.zeros((), dtype=g.dtype, device=g.device))


def _qkv(p: AttnParams, x, layout: str, n_kv: int, hd: int, positions,
         rope_theta: float, shape):
    """q, k, v of x (B, S, d), rotated at ``positions``: with the whole
    leaves (no tensor-parallel plan), or tensor-parallel: q of this rank's
    heads ('heads', column-parallel) or of every head (the other layouts:
    the column blocks' outputs gathered); k and v as a cache whose
    trailing dims are ``shape`` stores them (:func:`_cache_block`)."""
    if cm.tp_size() == 1:
        return _qkv_rotary(p, x, n_kv, hd, positions, rope_theta)
    mesh = cm.tp_mesh()
    B, S, _ = x.shape
    xin = cd.copy_to_model(x, mesh)
    proj = cd.local_gemm if layout == "heads" else \
        (lambda a, w, b: _proj_whole(a, w, b, mesh))
    q, k, v = (proj(xin, w, b).reshape(B, S, -1, hd)
               for w, b in ((p.wq, p.bq), (p.wk, p.bk), (p.wv, p.bv)))
    q, k = _rope(q, k, positions, hd, rope_theta)
    return q, _cache_block(k, shape, layout), _cache_block(v, shape, layout)


def _contract(p: AttnParams, q, x, gk, gv, valid, layout: str):
    """The masked contraction of ``q`` against a cache's gathered keys and
    values, then ``wo`` (:func:`_decode_contract` with the whole leaves).
    Tensor-parallel: this rank's heads ('heads'); its head_dim block with
    the scores summed over 'model' before the softmax and the output
    gathered over head_dim ('head_dim'); every head over this rank's block
    of the positions, the softmax normalized and the weighted V summed
    over 'model' ('seq', :func:`_softmax_over_model`); every head over
    every position ('whole'). ``wo`` row-parallel (of this rank's heads'
    rows) where it is a block of rows."""
    if cm.tp_size() == 1:
        return _decode_contract(p, q, x, gk, gv, valid)
    mesh = cm.tp_mesh()
    r = mesh.axis_index("model")
    B, S = x.shape[:2]
    qs = _scaled(q).to(gk.dtype)
    if layout == "head_dim":
        hd = gk.shape[-1]
        o = _attend(qs[..., r * hd:(r + 1) * hd], gk, gv, valid,
                    scores=lambda s: cd.reduce_from_model(s, mesh))
        o = cd.gather_from_model(o, mesh, -1)
    elif layout == "seq":
        o = _attend(qs, gk, gv, valid, mesh=mesh)
    else:
        o = _attend(qs, gk, gv, valid)
    o = o.reshape(B, S, -1).to(x.dtype)
    if cm.block_dim(p.wo) != 0:
        return cd.local_gemm(o, p.wo)
    n = cd.in_features(p.wo)
    if o.shape[-1] != n:  # every head's output: this rank's rows of wo
        o = o[..., r * n:(r + 1) * n]
    return cd.row_parallel(o, p.wo, mesh=mesh, out_dtype=x.dtype)


def prefill_attention(p: AttnParams, x: torch.Tensor, cache: KVCache, *,
                      rope_theta: float = 10000.0, chunk: int | None = 1024,
                      n_heads: int | None = None,
                      n_kv_heads: int | None = None,
                      head_dim: int | None = None
                      ) -> tuple[torch.Tensor, KVCache]:
    """Prefill: full self-attention + write the KV cache prefix in place
    (the counterpart of the reference's donated ``dynamic_update_slice``).
    The caller sets the length (``lm.prefill``). The head counts default
    to the cache's; under a tensor-parallel plan they are the model's
    (the cache is this rank's block, ``decode_state_specs``) and the
    attention runs as :func:`_attend_full` does. A cache whose sequence is
    split over DP keeps the positions it holds."""
    B, S, _ = x.shape
    n_kv = n_kv_heads or cache.k.shape[2]
    hd = head_dim or cache.k.shape[3]
    dp = _over_dp(cache.k.shape[0], cache.k.shape[0], -3, cache.k.shape[1])
    layout = _cache_layout(n_kv, hd, dp)
    if n_heads is None and cm.tp_size() > 1:
        raise ValueError("a tensor-parallel prefill needs the model's head "
                         "counts")
    y, k, v = _attend_full(
        p, x, None, n_heads=n_heads, n_kv=n_kv, hd=hd, causal=True,
        chunk=chunk, positions=torch.arange(S, device=x.device)[None, :],
        rope_theta=rope_theta)
    k = _cache_block(k, cache.k.shape[-2:], layout)
    v = _cache_block(v, cache.k.shape[-2:], layout)
    if dp is None or dp.held is None:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
    else:
        lo, n = dp.held
        m = max(0, min(n, S - lo))
        cache.k[:, :m] = k[:, lo:lo + m]
        cache.v[:, :m] = v[:, lo:lo + m]
    return y, cache


def _attend(qs, gk, gv, valid, scores=None, mesh=None) -> torch.Tensor:
    """The masked contraction: ``qs`` (B, S, H, D), scaled and in the
    cache's storage dtype, against the (B, K, Hkv, D) keys and values,
    accumulated in f32; ``valid`` (B, K) for one query a row (decode), (B,
    S, K) for S (verify). ``scores`` (if given) maps the raw scores before
    the mask (the sum over 'model' of head_dim blocks). ``mesh`` (if
    given): the keys, values and ``valid``'s last dim are this rank's
    block of positions split over 'model' (:func:`_softmax_over_model`),
    and the weighted V is summed over 'model'. Returns o (B, S, H, D)
    f32."""
    n_heads, n_kv = qs.shape[2], gk.shape[2]
    kr = _repeat_kv(gk, n_heads // n_kv)
    vr = _repeat_kv(gv, n_heads // n_kv)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kr.float())
    if scores is not None:
        s = scores(s)
    if valid.dim() == 2:
        valid = valid[:, None, :]
    s = torch.where(valid[:, None], s, NEG_INF)
    prob = (torch.softmax(s, dim=-1) if mesh is None
            else _softmax_over_model(s, mesh))
    o = torch.einsum("bhqk,bkhd->bqhd", prob.to(vr.dtype).float(),
                     vr.float())
    return o if mesh is None else cd.all_reduce(o, mesh, "model")


def _softmax_over_model(s, mesh) -> torch.Tensor:
    """The softmax of the f32 scores ``s`` (..., K) whose last dim is this
    rank's block of positions split over 'model': each rank's max and sum
    of exponentials all-gathered over 'model', and this rank's block of
    the probabilities normalized by the global max and sum, as one
    device's softmax normalizes them, so they round alike before the
    weighted V. A rank that holds no valid position weighs 0. Every rank
    combines the same parts in rank order."""
    m = s.amax(-1, keepdim=True)
    parts = cd.all_gather(torch.cat(
        [m, torch.exp(s - m).sum(-1, keepdim=True)], -1)[None], mesh,
        "model", 0)
    top = parts[..., :1].amax(0)
    total = (parts[..., 1:] * torch.exp(parts[..., :1] - top)).sum(0)
    return torch.exp(s - top) / total


def _decode_contract(p: AttnParams, q, x, gk, gv, valid) -> torch.Tensor:
    """The masked contraction of every decode path and of the verify pass
    (:func:`_attend`), then ``wo``."""
    B, S = x.shape[:2]
    o = _attend(_scaled(q).to(gk.dtype), gk, gv, valid)
    return cm.dense(o.reshape(B, S, -1).to(x.dtype), p.wo)


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
                     rope_theta: float = 10000.0,
                     n_heads: int | None = None,
                     n_kv_heads: int | None = None,
                     head_dim: int | None = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: x (B, 1, d) against the cache; the new K/V are
    written in place at ``cache.length``.

    A 0-d length puts every row at one position (static batching); a (B,)
    length is per slot (the engine's lanes). The caller advances the
    length (``lm.decode_step``, by the active lanes). A vacant lane may sit
    at ``length == S_max``, where the reference's ``mode="drop"`` scatter
    writes nothing: here its index is clamped to S_max - 1 and the old
    value written back, so the write is a no-op there too. A 0-d length
    past the cache writes at S_max - 1 instead, where the reference's
    ``dynamic_update_slice`` clamps its start, and every slot stays valid.

    Under a tensor-parallel plan the cache is this rank's block
    (:func:`_cache_layout`, the head counts are the model's): with kv heads
    over 'model', q, k and v of this rank's heads (column-parallel) and
    ``wo`` row-parallel; with head_dim over 'model', q, k and v of every
    head (the column blocks' outputs gathered), this rank's head_dim block
    written and contracted, the scores summed over 'model' before the
    softmax, the output gathered over head_dim before ``wo``
    (row-parallel) (:func:`_qkv`, :func:`_contract`). Where neither
    divides 'model', q, k and v of every head: the rank holding the
    position writes it (as over DP) and each rank contracts its block of
    the sequence, the softmax normalized over 'model' ('seq'), or
    every rank writes and contracts the whole cache ('whole').

    Over DP (a plan naming the state's layout) ``x`` may be this rank's
    lanes of the whole (B,) length, and the cache its lanes, or its block
    of the sequence: the rank holding a lane's position writes it (the
    others write the old value back) and the sequence is all-gathered for
    the contraction.
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    S_loc, n_kv, hd = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    per_slot = cache.length.dim() == 1
    dp = _over_dp(cache.length.shape[0] if per_slot else B, B, -3, S_loc)
    pos = cache.length
    if dp is not None and dp.lanes is not None:
        pos = pos[dp.lanes]
    positions = pos[:, None] if per_slot else pos.reshape(1, 1)
    layout = "whole"
    if cm.tp_size() > 1:
        if n_kv_heads is None or head_dim is None:
            raise ValueError("a tensor-parallel decode needs the model's "
                             "head counts")
        layout = _cache_layout(n_kv_heads, head_dim, dp)
        n_kv, hd = n_kv_heads, head_dim
    q, k, v = _qkv(p, x, layout, n_kv, hd, positions, rope_theta,
                   cache.k.shape[-2:])
    seq = None if dp is None else dp.held
    S_max = S_loc if seq is None else S_loc * cd.axes_extent(dp.mesh,
                                                             dp.over)
    at = pos.clamp(max=S_max - 1)
    own = None
    if seq is not None:  # the position's rank writes it
        at = at - seq[0]
        own = (at >= 0) & (at < S_loc)
        at = at.clamp(0, S_loc - 1)
    kpos = torch.arange(S_max, device=x.device)
    if per_slot:
        rows = torch.arange(B, device=x.device)
        keep = pos >= S_max
        if own is not None:
            keep = keep | ~own
        keep = keep[:, None, None]
        for c, new in ((cache.k, k), (cache.v, v)):
            c[rows, at] = torch.where(keep, c[rows, at], new[:, 0])
        valid = kpos[None, :] <= pos[:, None]
    else:
        at = at.reshape(1).long()
        for c, new in ((cache.k, k), (cache.v, v)):
            if own is not None:
                new = torch.where(own, new, c.index_select(1, at))
            c.index_copy_(1, at, new)
        valid = (kpos <= pos).expand(B, S_max)
    gk, gv = cache.k, cache.v
    if layout == "seq":  # this rank's positions, normalized over 'model'
        valid = valid[:, seq[0]:seq[0] + S_loc]
    elif seq is not None:
        gk, gv = (cd.all_gather_over(t, dp.mesh, dp.over, 1)
                  for t in (gk, gv))
    return _contract(p, q, x, gk, gv, valid, layout), cache


class PagedKVCache(NamedTuple):
    """Block-pool KV cache (port of the reference's ``PagedKVCache``).

    K/V live in a flat pool of fixed-size token blocks shared by every slot
    lane; a per-slot block table maps logical positions to pool blocks.
    Block 0 is the null block: vacant table entries point at it and
    redirected (inactive-lane, pad-position) writes land in it, so every
    write index is in range and every value a gather reads is finite;
    invalid positions are masked to ``NEG_INF`` before softmax.

    With ``kv_dtype=int8`` the pool stores K/V as int8 with per-block,
    per-kv-head symmetric absmax scales in ``k_scale`` / ``v_scale``:
    quantized at write time (:func:`_quantized_scatter`), dequantized
    inside the table-directed gather. ``k_scale is None`` is the
    activation-dtype pool.
    """

    k: torch.Tensor        # (num_blocks, block_size, Hkv, Dh) [(L, ...)]
    v: torch.Tensor        # activation dtype, or int8
    table: torch.Tensor    # (num_slots, max_blocks) int32 pool-block ids
    length: torch.Tensor   # (num_slots,) int32 tokens written per slot
    k_scale: torch.Tensor | None = None   # (num_blocks, Hkv) f32, int8 only
    v_scale: torch.Tensor | None = None   # [(L, ...)]


def init_paged_kv_cache(num_slots, num_blocks, block_size, max_blocks,
                        n_kv_heads, head_dim, dtype=torch.bfloat16, *,
                        kv_dtype=None, lead=(), device) -> PagedKVCache:
    """A zeroed pool in ``dtype`` (or int8, with scales of 1.0: a zero
    block dequantizes to zero at any scale and every scale a gather reads
    stays finite); ``lead`` prepends stacking dims (the layer axis) to the
    pool's leaves."""
    kvd = KVCacheDtype.parse(kv_dtype)
    shape = (*lead, num_blocks, block_size, n_kv_heads, head_dim)
    sd = kvd.storage_dtype if kvd.quantized else dtype
    scales = lambda: (torch.ones((*lead, num_blocks, n_kv_heads),
                                 dtype=torch.float32, device=device)
                      if kvd.quantized else None)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=sd, device=device),
        v=torch.zeros(shape, dtype=sd, device=device),
        table=torch.zeros((num_slots, max_blocks), dtype=torch.int32,
                          device=device),
        length=torch.zeros((num_slots,), dtype=torch.int32, device=device),
        k_scale=scales(), v_scale=scales())


def reset_paged_kv_cache(cache: PagedKVCache) -> None:
    """Put a pool back to what :func:`init_paged_kv_cache` made, in place
    (a captured step holds its addresses): zeros, and an int8 pool's
    scales 1.0."""
    for t in (cache.k, cache.v, cache.table, cache.length):
        t.zero_()
    if cache.k_scale is not None:
        cache.k_scale.fill_(1.0)
        cache.v_scale.fill_(1.0)


def _pool_gather(cache: PagedKVCache, idx: torch.Tensor, dtype
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V of the pool blocks ``idx`` (any shape, each entry a block
    id), ``(*idx.shape, block_size, Hkv, Dh)``: an int8 pool dequantized to
    ``dtype``, an activation-dtype pool as it is stored."""
    if cache.k_scale is None:
        return cache.k[idx], cache.v[idx]
    return (q8.dequantize_block(cache.k[idx], cache.k_scale[idx], dtype),
            q8.dequantize_block(cache.v[idx], cache.v_scale[idx], dtype))


def _quantized_scatter(pool, scales, blk, keep_old, write_new, newv,
                       held=None, reduce=None) -> None:
    """Whole-block dequantize, merge and requantize write into the int8
    pool, in place (the reference's ``_quantized_scatter``).

    ``blk`` (T,) are the touched pool blocks; ``keep_old`` / ``write_new``
    (T, block_size) mask block offsets; ``newv`` (T, block_size, Hkv, Dh)
    holds the incoming values at ``write_new`` offsets. Offsets neither
    kept nor written are zeroed, so a block's scale depends only on the
    tokens valid in it.

    Distinct lanes own distinct blocks, so duplicate indices only collide
    on the null block 0 (inactive decode lanes; a chunk's candidates past
    its blocks). Its content is never validly read by a live lane, but a
    vacant lane attends to it, and under W8A8 that lane's row enters the
    per-tensor activation scale every lane shares. A CUDA ``index_put_``
    with duplicate indices may keep any of them, so each row writes the
    merged block of the last row bound for the same block: every duplicate
    carries the same bytes, the write is deterministic (a replayed step
    equals its eager run on every block, block 0 included), and the result
    is what the reference's sequential scatter on the CPU keeps.

    ``held`` = (first, count): the pool is this rank's block of the block
    axis (ids global); rows bound elsewhere write nothing (they carry the
    bytes local block 0 ends with). ``reduce``: a pool whose head_dim lies
    over 'model' takes each merged block's per-kv-head absmax over every
    rank of it (:func:`q8.quantize_block`'s ``reduce``), so the scales,
    replicated over 'model', are the whole pool's.
    """
    rows = torch.arange(blk.shape[0], device=blk.device)
    own = None
    if held is not None:
        lo, n = held
        own = (blk >= lo) & (blk < lo + n)
        blk = torch.where(own, blk - lo, 0)
    old = q8.dequantize_block(pool[blk], scales[blk])
    merged = torch.where(write_new[..., None, None], newv.float(),
                         torch.where(keep_old[..., None, None], old, 0.0))
    qblk, qs = q8.quantize_block(merged, reduce)
    same = blk[:, None] == blk[None, :]
    if own is None:
        last = torch.where(same, rows, -1).amax(dim=1)
        pool[blk] = qblk[last]
        scales[blk] = qs[last]
        return
    last = torch.where(same & own[None, :], rows, -1).amax(dim=1)
    mine = last >= 0
    at = last.clamp(min=0)
    pool[blk] = torch.where(mine[:, None, None, None], qblk[at], pool[blk])
    scales[blk] = torch.where(mine[:, None], qs[at], scales[blk])


def _pool_write(cache: PagedKVCache, k, v, row, start, n, spill, span: int,
                held=None, reduce=None) -> None:
    """Write the K/V of W consecutive positions a lane into the pool, in
    place: the one pool write of prefill, decode and verify, for both
    formats.

    ``k``, ``v`` (B, W, Hkv, Dh) hold lane b's values at positions
    ``start[b] + j``; the first ``n`` (0-d or (B,)) are real, the rest
    padding. ``row`` (B, max_blocks) are the lanes' table rows, ``spill``
    (B,) bool or None marks lanes whose writes go to the null block
    (inactive lanes: a vacant lane's row may name blocks the allocator gave
    to another request). Positions and blocks past the table go to the
    null block too: a verify window near a lane's budget runs past
    ``max_len``, and a clamped index would alias the last owned block.

    Activation-dtype pool: each real position goes to (its block, offset),
    each pad position to (null block, offset 0). Duplicate destinations
    (all in block 0) carry the last such row's value, so a CUDA
    ``index_put_``, which may keep any of them, writes deterministic bytes
    (a replayed step equals its eager run, block 0 included) and keeps what
    the reference's sequential scatter on the CPU keeps.

    int8 pool: ``span`` consecutive table entries from ``start // bs`` are
    rewritten whole (:func:`_quantized_scatter`, ``reduce`` its absmax's
    MAX over 'model' for a head_dim pool): offsets before ``start`` kept,
    the window's real positions written, the rest zeroed.

    ``held`` = (first, count): the pool is this rank's block of the block
    axis (a pool split over DP; the table's ids global). Only the rows
    bound for a block held here are written, by the same last-row rule over
    every row, so each rank's blocks end with the bytes the whole pool's
    would; rows bound elsewhere carry what local (block 0, offset 0) ends
    with.
    """
    B, W = k.shape[:2]
    bs = cache.k.shape[1]
    mb = row.shape[1]
    dev = k.device
    start = start.reshape(-1, 1)                         # (B or 1, 1)
    end = start + (n.reshape(-1, 1) if isinstance(n, torch.Tensor) else n)
    lanes = torch.arange(B, device=dev)[:, None]
    live = True if spill is None else ~spill.bool()[:, None]
    if cache.k_scale is None:
        pos = start + torch.arange(W, device=dev)[None, :]        # (B, W)
        real = pos < end
        ok = real & live & (pos < mb * bs)
        blk = torch.where(ok, row[lanes, torch.clamp(pos // bs, max=mb - 1)],
                          0).reshape(-1)
        off = torch.where(real, pos % bs, 0).reshape(-1)
        rows = torch.arange(B * W, device=dev)
        if held is None:
            key = blk * bs + off
            last = torch.where(key[:, None] == key[None, :], rows,
                               -1).amax(dim=1)
            for pool, new in ((cache.k, k), (cache.v, v)):
                pool[blk, off] = new.reshape(B * W, *new.shape[2:])[last]
            return
        lo, nb = held
        own = (blk >= lo) & (blk < lo + nb)
        blk = torch.where(own, blk - lo, 0)
        off = torch.where(own, off, 0)
        key = blk * bs + off
        last = torch.where((key[:, None] == key[None, :]) & own[None, :],
                           rows, -1).amax(dim=1)
        mine = (last >= 0)[:, None, None]
        at = last.clamp(min=0)
        for pool, new in ((cache.k, k), (cache.v, v)):
            pool[blk, off] = torch.where(
                mine, new.reshape(B * W, *new.shape[2:])[at], pool[blk, off])
        return
    cand = start // bs + torch.arange(span, device=dev)[None, :]  # (B, T)
    ok = (cand < mb) & live
    blk = torch.where(ok, row[lanes, torch.clamp(cand, max=mb - 1)], 0)
    bpos = cand[:, :, None] * bs + torch.arange(bs, device=dev)   # (B, T, bs)
    at = start[:, :, None]
    write_new = (bpos >= at) & (bpos < end[:, :, None])
    keep_old = bpos < at
    src = torch.clamp(bpos - at, 0, W - 1)
    for pool, scales, new in ((cache.k, cache.k_scale, k),
                              (cache.v, cache.v_scale, v)):
        _quantized_scatter(
            pool, scales, blk.reshape(-1), keep_old.expand_as(bpos).reshape(
                -1, bs), write_new.expand_as(bpos).reshape(-1, bs),
            new[lanes[:, :, None], src].reshape(-1, bs, *new.shape[2:]),
            held, reduce)


def _pool_layout(cache: PagedKVCache, n_kv: int, hd: int) -> str:
    """How a pool lies over 'model' (``decode_state_specs(paged=True)``):
    as :func:`_cache_layout` lays a contiguous cache, whole where neither
    its kv heads nor its head_dim divide 'model' (every rank holds every
    block and writes the new rows whole). An int8 pool's ``(num_blocks,
    Hkv)`` scales follow its kv heads ('heads': each rank quantizes its
    own) or stay whole on every rank ('head_dim': each block's absmax
    taken over 'model', :func:`_pool_reduce`; 'whole': every rank
    quantizes every block alike)."""
    return _cache_layout(n_kv, hd)


def _pool_reduce(cache: PagedKVCache, layout: str):
    """The int8 pool's absmax reduction for ``layout`` (None: local)."""
    if cache.k_scale is None or layout != "head_dim":
        return None
    mesh = cm.tp_mesh()
    return lambda amax: cd.scale_max(amax, mesh, "model")


def _pool_dp(cache: PagedKVCache, rows: int | None) -> _DP | None:
    """:func:`_over_dp` of a pool: ``rows`` lanes of the table's (None: a
    prefill chunk, one request on every rank), its blocks split where the
    plan's layout splits them."""
    total = cache.table.shape[0]
    return _over_dp(total, total if rows is None else rows, -4,
                    cache.k.shape[0])


def _paged_write(cache: PagedKVCache, k, v, row, start, n, spill, span: int,
                 dp: _DP | None, reduce=None) -> None:
    """:func:`_pool_write` of a step's rows: a lane-split step's new K/V
    all-gathered over DP first (``row``, ``start`` and ``spill`` are every
    lane's), each rank writing the blocks it holds."""
    if dp is not None and dp.lanes is not None:
        k, v = (cd.all_gather_over(t, dp.mesh, dp.entry, 0) for t in (k, v))
    _pool_write(cache, k, v, row, start, n, spill, span,
                None if dp is None else dp.held, reduce)


def _paged_kv(cache: PagedKVCache, rows, dtype, dp: _DP | None):
    """K and V (R, max_blocks * bs, Hkv', Dh) of the table rows ``rows``
    (every lane's, or a chunk's), for this rank's lanes: an int8 pool
    dequantized to ``dtype``. A pool split over DP gathers the blocks it
    holds, zeros for the others, and sums over DP (:func:`_dp_sum`)."""
    R, mb = rows.shape
    bs = cache.k.shape[1]
    if dp is None or dp.held is None:
        if dp is not None and dp.lanes is not None:
            rows = rows[dp.lanes]
        gk, gv = _pool_gather(cache, rows, dtype)
    else:
        parts = [_dp_sum(_held(t, rows, dp.held), dp)
                 for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
                 if t is not None]
        gk, gv = parts[:2]
        if cache.k_scale is not None:
            gk = q8.dequantize_block(gk, parts[2], dtype)
            gv = q8.dequantize_block(gv, parts[3], dtype)
    return (g.reshape(g.shape[0], mb * bs, *g.shape[-2:]) for g in (gk, gv))


def _paged_attention(p: AttnParams, x, cache: PagedKVCache, *, positions,
                     row, start, n, spill, span: int, dp: _DP | None,
                     heads: dict, rope_theta: float):
    """The paged step's attention: q, k, v of ``x`` rotated at
    ``positions`` (B, S), the new K/V written through the table rows
    ``row`` from ``start`` (``n`` real a row, ``span`` int8 blocks;
    :func:`_paged_write`), the rows' K/V gathered back
    (:func:`_paged_kv`), each query attending causally to its lane's
    written prefix (:func:`_contract`). Under a tensor-parallel plan the
    pool is this rank's kv heads or head_dim block, or whole
    (:func:`_pool_layout`, ``heads`` the model's head counts)."""
    bs, n_kv, hd = cache.k.shape[1:]
    mb = row.shape[1]
    layout = "whole"
    if cm.tp_size() > 1:
        if heads.get("n_kv_heads") is None or heads.get("head_dim") is None:
            raise ValueError("a tensor-parallel paged step needs the "
                             "model's head counts")
        n_kv, hd = heads["n_kv_heads"], heads["head_dim"]
        layout = _pool_layout(cache, n_kv, hd)
    q, k, v = _qkv(p, x, layout, n_kv, hd, positions, rope_theta,
                   cache.k.shape[-2:])
    _paged_write(cache, k, v, row, start, n, spill, span, dp,
                 _pool_reduce(cache, layout))
    gk, gv = _paged_kv(cache, row, q.dtype, dp)
    kpos = torch.arange(mb * bs, device=x.device)
    valid = kpos[None, None, :] <= positions[:, :, None]        # (B, S, K)
    return _contract(p, q, x, gk, gv, valid, layout)


def paged_prefill_attention(p: AttnParams, x: torch.Tensor,
                            cache: PagedKVCache, *, slot, start, true_len,
                            rope_theta: float = 10000.0, **heads
                            ) -> tuple[torch.Tensor, PagedKVCache]:
    """One prefill chunk for the request in lane ``slot`` (0-d int
    tensors: ``slot``, ``start`` = prompt tokens earlier chunks wrote,
    ``true_len`` <= C = real tokens of this chunk).

    ``x`` is (1, C, d), right-padded to the bucket C. The chunk's K/V
    scatter into the slot's blocks at positions start..start+true_len-1;
    pad positions go to (null block, offset 0), so no index leaves the
    pool. An int8 pool rewrites every block the chunk touches whole: at
    most C // bs + 2 consecutive table entries from start // bs, those past
    the table sent to the null block (:func:`_pool_write`). Queries then
    attend causally to the slot's whole written prefix through the block
    table (an int8 pool dequantized inside the gather, to the activation
    dtype). ``heads``: the model's head counts (``n_heads``,
    ``n_kv_heads``, ``head_dim``), which a tensor-parallel step needs; over
    DP the chunk runs on every rank, each writing the blocks it holds.
    """
    B, C, _ = x.shape
    if B != 1:
        raise ValueError(f"a prefill chunk is one request, got {B} rows")
    bs = cache.k.shape[1]
    pos = start + torch.arange(C, device=x.device)
    # (1, max_blocks); indexing with the 0-d tensor itself would read it back
    row = cache.table.index_select(0, slot.reshape(1))
    return _paged_attention(
        p, x, cache, positions=pos[None, :], row=row, start=start,
        n=true_len, spill=None, span=C // bs + 2, dp=_pool_dp(cache, None),
        heads=heads, rope_theta=rope_theta), cache


def paged_decode_attention(p: AttnParams, x: torch.Tensor,
                           cache: PagedKVCache, *,
                           rope_theta: float = 10000.0,
                           active: torch.Tensor | None = None, **heads
                           ) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step against the block pool: the contraction of the
    contiguous per-slot :func:`decode_attention` over the same logical
    positions, gathered through the table.

    ``active`` (num_slots,) marks live lanes; an inactive lane's write goes
    to the null block (its table row may name blocks the allocator gave to
    another request), and so does a position past the table. On an int8
    pool each lane rewrites its current block whole: the offsets before
    the append point kept, the tail past it zeroed (:func:`_pool_write`).
    The caller advances the length. Over DP ``x`` may be this rank's lanes
    (``active`` and the lengths are every lane's).
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    dp = _pool_dp(cache, B)
    pos = cache.length                                      # (num_slots,)
    mine = pos if dp is None or dp.lanes is None else pos[dp.lanes]
    return _paged_attention(
        p, x, cache, positions=mine[:, None], row=cache.table, start=pos,
        n=1, spill=None if active is None else ~active.bool(), span=1,
        dp=dp, heads=heads, rope_theta=rope_theta), cache


def paged_verify_attention(p: AttnParams, x: torch.Tensor,
                           cache: PagedKVCache, *,
                           rope_theta: float = 10000.0,
                           active: torch.Tensor | None = None, **heads
                           ) -> tuple[torch.Tensor, PagedKVCache]:
    """Speculative-verify step: S candidate tokens per lane in one pass
    (the reference's ``paged_verify_attention``).

    ``x`` is (B, S, d): for every lane, the last committed token followed
    by the draft's S - 1 proposals. All S keys and values are written
    through the block table at positions ``length .. length + S - 1``
    (:func:`_pool_write`: an inactive lane's writes, and a position past
    the table, go to the null block; an int8 pool rewrites the S // bs + 2
    candidate blocks whole), then each query attends causally through the
    table, so position i's scores are what i sequential
    :func:`paged_decode_attention` steps compute for the same tokens. A
    lane's rejected tail stays in its blocks until the next round rewrites
    those positions; causality keeps any committable query from attending
    it. The caller (``lm.verify_step``) advances the lengths and the engine
    rewinds the rejected tail. Over DP ``x`` may be this rank's lanes.
    """
    B, S, _ = x.shape
    bs = cache.k.shape[1]
    dp = _pool_dp(cache, B)
    length = cache.length
    mine = length if dp is None or dp.lanes is None else length[dp.lanes]
    pos = mine[:, None] + torch.arange(S, device=x.device)      # (B, S)
    return _paged_attention(
        p, x, cache, positions=pos, row=cache.table, start=length, n=S,
        spill=None if active is None else ~active.bool(), span=S // bs + 2,
        dp=dp, heads=heads, rope_theta=rope_theta), cache
