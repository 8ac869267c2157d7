"""Decoder-only LM, dense and RWKV-6 families (port of ``repro.models.lm``).

Parameters are the reference's tree: plain dicts and NamedTuples, layers
stacked on a leading L axis. ``lax.scan`` over layers becomes a Python loop
over views of the stacked leaves; the decode state (the dense KV cache
(L, B, S_max, Hkv, Dh) or paged pool (L, blocks, block, Hkv, Dh) with its
int32 lengths and block table, or the rwkv WKV state (L, B, H, N, N) and
token shifts (L, B, d)) is written in place, lengths included, the
counterpart of the reference's ``donate_argnums``: a step captured as a
CUDA graph keeps writing the same buffers.

Entry points: init_lm, forward, init_decode_state, prefill, prefill_chunk,
decode_step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import rwkv as rwkv_lib

FAMILIES = ("dense", "rwkv")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            "item 9: other model families)")


# ---------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, d: int, *, lead=(), device):
    ones = torch.ones((*lead, d), dtype=cfg.pdtype, device=device)
    if cfg.norm_type == "layernorm":
        return {"g": ones, "b": torch.zeros_like(ones)}
    return {"g": ones}


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm_type == "layernorm":
        return cm.layer_norm(x, p["g"], p["b"], cfg.norm_eps)
    return cm.rms_norm(x, p["g"], cfg.norm_eps)


# ---------------------------------------------------------------- init
def init_lm(cfg: ModelConfig, *, seed: int = 0, device) -> dict[str, Any]:
    """Random weights with the reference's tree, shapes and dtypes, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    values differ from ``jax.random``'s; ``interop.params_from_jax`` carries
    reference weights over instead)."""
    cfg.validate()
    _check_family(cfg)
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d, dt, L = cfg.d_model, cfg.pdtype, cfg.n_layers
    Vp = cfg.padded_vocab
    params: dict[str, Any] = {
        "embed": cm.normal_init(gen, (Vp, d), dt, scale=0.02, device=device),
        "final_norm": init_norm(cfg, d, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = cm.normal_init(gen, (d, Vp), dt, device=device)
    layers = {
        "ln1": init_norm(cfg, d, lead=(L,), device=device),
        "ln2": init_norm(cfg, d, lead=(L,), device=device),
    }
    if cfg.family == "rwkv":
        layers["tmix"] = rwkv_lib.init_time_mix(gen, d, dtype=dt, lead=(L,),
                                                device=device)
        layers["cmix"] = rwkv_lib.init_channel_mix(
            gen, d, cfg.d_ff, dtype=dt, lead=(L,), device=device)
    else:
        layers["attn"] = attn.init_attn(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=(L,), device=device)
        layers["mlp"] = mlp_lib.init_mlp(
            gen, d, cfg.d_ff, gated=cfg.gated_mlp, bias=False, dtype=dt,
            lead=(L,), device=device)
    params["layers"] = layers
    return params


def _layer(layers, i: int):
    """Layer ``i`` of the stacked layer tree (views, no copies)."""
    return interop.tree_map(lambda t: t[i], layers)


def _attn_kw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                chunk=cfg.attn_chunk)


def _embed(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    return cm.embed_lookup(params["embed"], tokens).to(cfg.dtype)


def _ffn(cfg: ModelConfig, lp, x):
    return mlp_lib.mlp(lp["mlp"], apply_norm(cfg, lp["ln2"], x),
                       activation=cfg.activation)


def _rwkv_block(cfg: ModelConfig, lp, x, tmix_state=None,
                shifts=(None, None)):
    """Returns (x, (wkv state, time-mix shift, channel-mix shift))."""
    h = apply_norm(cfg, lp["ln1"], x)
    y, (new_state, last_att) = rwkv_lib.time_mix(
        lp["tmix"], h, n_heads=cfg.n_heads, state=tmix_state,
        x_prev=shifts[0])
    x = x + y
    h2 = apply_norm(cfg, lp["ln2"], x)
    y2, last_ffn = rwkv_lib.channel_mix(lp["cmix"], h2, x_prev=shifts[1])
    return x + y2, (new_state, last_att, last_ffn)


def _write_rwkv_state(state, i: int, new) -> None:
    """Layer ``i``'s new (wkv, att_shift, ffn_shift) into the stacked
    decode state, in place."""
    for key, t in zip(("wkv", "att_shift", "ffn_shift"), new):
        state[key][i].copy_(t)


# ---------------------------------------------------------------- forward
def forward(params, tokens, cfg: ModelConfig):
    """tokens (B, S) -> (hidden (B, S, d), aux_loss scalar)."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.family == "rwkv":
            x, _ = _rwkv_block(cfg, lp, x)
            continue
        x = x + attn.self_attention(lp["attn"], apply_norm(cfg, lp["ln1"], x),
                                    **_attn_kw(cfg))
        x = x + _ffn(cfg, lp, x)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _logits(params, cfg: ModelConfig, h):
    """Unembed. Tied embeddings use the (V, d) table as a column-major B."""
    if cfg.tie_embeddings:
        return cm.balanced_gemm(h, params["embed"], b_layout="col",
                                out_dtype=torch.float32)
    return cm.dense(h, params["unembed"], out_dtype=torch.float32)


# ---------------------------------------------------------------- decode
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      per_slot: bool = False,
                      kv_block_size: int | None = None,
                      num_kv_blocks: int | None = None, device):
    """dense: contiguous KV cache (L, B, max_len, Hkv, Dh) in the activation
    dtype with an int32 length, 0-d (one for every row) or, ``per_slot``,
    (B,) (the engine's lanes). ``kv_block_size`` switches the per-slot
    cache to the paged pool: ``num_kv_blocks`` blocks of ``kv_block_size``
    tokens (block 0 the null block) and a (B, ceil(max_len / block))
    table. rwkv: the WKV state (L, B, H, N, N) f32 and the token shifts
    (L, B, d) in the activation dtype; ``max_len`` does not bound it."""
    _check_family(cfg)
    L, d = cfg.n_layers, cfg.d_model
    if kv_block_size:
        if cfg.family != "dense":
            raise ValueError(
                f"paged KV needs a KV-cache family, not {cfg.family!r}")
        if not per_slot:
            raise ValueError("paged KV is a per-slot (engine) layout")
        if num_kv_blocks is None or num_kv_blocks < 2:
            raise ValueError(
                f"paged KV needs num_kv_blocks >= 2 (block 0 is the null "
                f"block), got {num_kv_blocks}")
        kv = attn.init_paged_kv_cache(
            batch, num_kv_blocks, kv_block_size, -(-max_len // kv_block_size),
            cfg.n_kv_heads, cfg.head_dim, cfg.dtype, device=device)
        shape = (L, *kv.k.shape)
        return {"kv": kv._replace(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device))}
    if cfg.family == "rwkv":
        if per_slot:
            raise ValueError("per-slot decode state needs a KV-cache family, "
                             f"not {cfg.family!r}")
        H = cfg.n_heads
        N = d // H
        return {
            "wkv": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                               device=device),
            "att_shift": torch.zeros((L, batch, d), dtype=cfg.dtype,
                                     device=device),
            "ffn_shift": torch.zeros((L, batch, d), dtype=cfg.dtype,
                                     device=device),
        }
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": attn.KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device))}


def _at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) at position ``pos`` (0-d, or (B,)) of each row:
    (B, 1, d), a gather with a device index."""
    idx = pos.reshape(-1, 1, 1).long().expand(x.shape[0], 1, x.shape[2])
    return torch.gather(x, 1, idx)


def prefill(params, tokens, cfg: ModelConfig, state, last_pos=None):
    """Full-sequence prefill populating the decode state in place.

    Returns (last-token logits (B, Vp) f32, state). ``last_pos`` (0-d or
    (B,) int tensor) selects the position whose logits are returned
    instead of the last: the contiguous engine right-pads every prompt to
    one length and reads each request's true last token. The rwkv family
    starts from zero state whatever ``state`` holds, as the reference's
    does, and overwrites it."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
    if cfg.family == "rwkv":
        for i in range(cfg.n_layers):
            x, new = _rwkv_block(cfg, _layer(params["layers"], i), x)
            _write_rwkv_state(state, i, new)
    else:
        S = tokens.shape[1]
        kv = state["kv"]
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(cfg, lp["ln1"], x)
            cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
            y, _ = attn.prefill_attention(lp["attn"], h, cache,
                                          rope_theta=cfg.rope_theta,
                                          chunk=cfg.attn_chunk)
            x = x + y
            x = x + _ffn(cfg, lp, x)
        kv.length.fill_(S)
    h_last = x[:, -1:] if last_pos is None else _at(x, last_pos)
    h_last = apply_norm(cfg, params["final_norm"], h_last)
    return _logits(params, cfg, h_last)[:, 0], state


def prefill_chunk(params, tokens, cfg: ModelConfig, state, *, slot, start,
                  true_len, blocks):
    """One chunked-prefill step into a paged decode state, in place.

    ``tokens`` (1, C): the next chunk of one request's prompt, right-padded
    to the bucket C. 0-d int tensors: ``slot`` (the lane), ``start``
    (tokens earlier chunks wrote), ``true_len`` (real tokens in this
    chunk); ``blocks`` (max_blocks,) is the lane's block-table row,
    installed on every chunk (idempotent). Returns (logits (1, Vp) at the
    chunk's last real token, state). Every position is a tensor, so one
    captured graph per bucket serves every admission."""
    _check_family(cfg)
    if cfg.family != "dense":
        raise ValueError(
            f"chunked prefill needs a KV-cache family, not {cfg.family!r}")
    kv = state["kv"]
    if not isinstance(kv, attn.PagedKVCache):
        raise ValueError("prefill_chunk requires a paged decode state "
                         "(init_decode_state with kv_block_size)")
    lane = slot.reshape(1).long()
    kv.table.index_copy_(0, lane, blocks.reshape(1, -1).to(kv.table.dtype))
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = apply_norm(cfg, lp["ln1"], x)
        cache = attn.PagedKVCache(k=kv.k[i], v=kv.v[i], table=kv.table,
                                  length=kv.length)
        y, _ = attn.paged_prefill_attention(
            lp["attn"], h, cache, slot=slot, start=start, true_len=true_len,
            rope_theta=cfg.rope_theta)
        x = x + y
        x = x + _ffn(cfg, lp, x)
    kv.length.index_copy_(0, lane,
                          (start + true_len).reshape(1).to(kv.length.dtype))
    h_last = apply_norm(cfg, params["final_norm"], _at(x, true_len - 1))
    return _logits(params, cfg, h_last)[:, 0], state


def decode_step(params, tokens, cfg: ModelConfig, state, active=None):
    """One decode step. tokens (B, 1) -> (logits (B, Vp) f32, state).

    ``active`` (B,) int marks the live lanes of a per-slot state: an
    inactive lane's length does not advance (the dense family only, as in
    the reference's engine). The lengths advance in place."""
    _check_family(cfg)
    if active is not None and cfg.family != "dense":
        raise ValueError(
            f"per-slot active masks need a KV-cache family, not {cfg.family!r}")
    x = _embed(params, tokens, cfg)
    if cfg.family == "rwkv":
        for i in range(cfg.n_layers):
            x, new = _rwkv_block(
                cfg, _layer(params["layers"], i), x,
                tmix_state=state["wkv"][i],
                shifts=(state["att_shift"][i], state["ffn_shift"][i]))
            _write_rwkv_state(state, i, new)
        h = apply_norm(cfg, params["final_norm"], x)
        return _logits(params, cfg, h)[:, 0], state
    kv = state["kv"]
    paged = isinstance(kv, attn.PagedKVCache)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = apply_norm(cfg, lp["ln1"], x)
        if paged:
            cache = attn.PagedKVCache(k=kv.k[i], v=kv.v[i], table=kv.table,
                                      length=kv.length)
            y, _ = attn.paged_decode_attention(
                lp["attn"], h, cache, rope_theta=cfg.rope_theta,
                active=active)
        else:
            cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
            y, _ = attn.decode_attention(lp["attn"], h, cache,
                                         rope_theta=cfg.rope_theta)
        x = x + y
        x = x + _ffn(cfg, lp, x)
    kv.length.add_(1 if active is None else active.to(kv.length.dtype))
    h = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0], state
