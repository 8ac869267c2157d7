"""Decoder-only LM, dense family (port of ``repro.models.lm``).

Parameters are the reference's tree: plain dicts and NamedTuples, layers
stacked on a leading L axis. ``lax.scan`` over layers becomes a Python loop
over views of the stacked leaves; the KV cache (L, B, S_max, Hkv, Dh) is
written in place, the counterpart of the reference's ``donate_argnums``.

Entry points: init_lm, forward, init_decode_state, prefill, decode_step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers import mlp as mlp_lib


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
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
    params["layers"] = {
        "ln1": init_norm(cfg, d, lead=(L,), device=device),
        "ln2": init_norm(cfg, d, lead=(L,), device=device),
        "attn": attn.init_attn(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dt, lead=(L,), device=device),
        "mlp": mlp_lib.init_mlp(
            gen, d, cfg.d_ff, gated=cfg.gated_mlp, bias=False, dtype=dt,
            lead=(L,), device=device),
    }
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


# ---------------------------------------------------------------- forward
def forward(params, tokens, cfg: ModelConfig):
    """tokens (B, S) -> (hidden (B, S, d), aux_loss scalar)."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
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
                      device):
    """Contiguous KV cache (L, B, max_len, Hkv, Dh) in the activation dtype
    with one scalar length for every row."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": attn.KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=0)}


def prefill(params, tokens, cfg: ModelConfig, state):
    """Full-sequence prefill populating the decode state in place.

    Returns (last-token logits (B, Vp) f32, new state)."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
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
    new_state = {"kv": attn.KVCache(k=kv.k, v=kv.v, length=S)}
    h_last = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return _logits(params, cfg, h_last)[:, 0], new_state


def decode_step(params, tokens, cfg: ModelConfig, state):
    """One decode step. tokens (B, 1) -> (logits (B, Vp) f32, new state)."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
    kv = state["kv"]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = apply_norm(cfg, lp["ln1"], x)
        cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
        y, _ = attn.decode_attention(lp["attn"], h, cache,
                                     rope_theta=cfg.rope_theta)
        x = x + y
        x = x + _ffn(cfg, lp, x)
    new_state = {"kv": attn.KVCache(k=kv.k, v=kv.v, length=kv.length + 1)}
    h = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0], new_state
