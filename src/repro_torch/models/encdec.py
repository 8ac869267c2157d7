"""Encoder-decoder backbone, whisper-base (port of ``repro.models.encdec``).

The audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, encoder_len, d). The encoder
(non-causal self-attention without rope) and the decoder (causal
self-attention with rope, cross-attention to the encoder's output, MLP)
route every projection through :func:`repro_torch.layers.common.dense`.
The reference's choices are kept: the decoder uses rope, and every decode
step recomputes the cross K/V from ``enc``.

The decode state is the decoder's contiguous KV cache (L, B, S_max, Hkv,
Dh) with a 0-d length, and ``enc`` (B, encoder_len, d): prefill writes
both in place, so a decode step captured as a CUDA graph reads the
encoder's output from the same buffer at every replay.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers import mlp as mlp_lib
from repro_torch.models.lm import (_embed, _heads_kw, _layer, _logits,
                                   _prefix_axes, _remat, _unstack,
                                   apply_norm, init_norm, norm_axes)


def init_encdec(cfg: ModelConfig, *, seed: int = 0, device
                ) -> dict[str, Any]:
    """Random weights with the reference's tree, shapes and dtypes, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    cfg.validate()
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d, dt = cfg.d_model, cfg.pdtype
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    norm = lambda n: init_norm(cfg, d, lead=(n,), device=device)
    a_init = lambda n: attn.init_attn(
        gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        qkv_bias=cfg.qkv_bias, dtype=dt, lead=(n,), device=device)
    m_init = lambda n: mlp_lib.init_mlp(
        gen, d, cfg.d_ff, gated=cfg.gated_mlp, bias=cfg.qkv_bias, dtype=dt,
        lead=(n,), device=device)
    params: dict[str, Any] = {
        "embed": cm.normal_init(gen, (cfg.padded_vocab, d), dt, scale=0.02,
                                device=device),
        "enc_norm": init_norm(cfg, d, device=device),
        "final_norm": init_norm(cfg, d, device=device),
        "encoder": {"ln1": norm(Le), "ln2": norm(Le), "attn": a_init(Le),
                    "mlp": m_init(Le)},
        "decoder": {"ln1": norm(Ld), "ln2": norm(Ld), "ln3": norm(Ld),
                    "attn": a_init(Ld), "cross": a_init(Ld),
                    "mlp": m_init(Ld)},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = cm.normal_init(gen, (d, cfg.padded_vocab), dt,
                                           device=device)
    return params


def _kw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, chunk=cfg.attn_chunk)


def encdec_axes(cfg: ModelConfig):
    """The logical sharding axes of :func:`init_encdec`'s tree."""
    blk = lambda: {
        "ln1": _prefix_axes(norm_axes(cfg)),
        "ln2": _prefix_axes(norm_axes(cfg)),
        "attn": _prefix_axes(attn.attn_axes(cfg.qkv_bias)),
        "mlp": _prefix_axes(mlp_lib.mlp_axes(cfg.gated_mlp, cfg.qkv_bias)),
    }
    ax: dict[str, Any] = {
        "embed": ("vocab", None),
        "enc_norm": norm_axes(cfg),
        "final_norm": norm_axes(cfg),
        "encoder": blk(),
        "decoder": {
            **blk(),
            "ln3": _prefix_axes(norm_axes(cfg)),
            "cross": _prefix_axes(attn.attn_axes(cfg.qkv_bias)),
        },
    }
    if not cfg.tie_embeddings:
        ax["unembed"] = (None, "vocab")
    return ax


def _encoder_layer(cfg: ModelConfig, lp, x):
    lp = cm.gathered(lp, "encoder")
    x = x + attn.self_attention(
        lp["attn"], apply_norm(cfg, lp["ln1"], x), causal=False,
        use_rope=False, rope_theta=cfg.rope_theta, **_kw(cfg))
    return x + mlp_lib.mlp(lp["mlp"], apply_norm(cfg, lp["ln2"], x),
                           activation=cfg.activation)


def encode(params, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames: precomputed (B, encoder_len, d) frame embeddings (the
    frontend stub) -> the encoder's normed output. With ``cfg.remat``
    under grad each layer is recomputed in the backward, as the
    reference's."""
    x = frames.to(cfg.dtype)
    for lp in _unstack(params["encoder"], cfg.n_encoder_layers):
        x = _remat(cfg, lambda x, lp: _encoder_layer(cfg, lp, x))(x, lp)
    return apply_norm(cfg, params["enc_norm"], x)


def _cross_mlp(cfg: ModelConfig, lp, x, enc):
    """The decoder layer's cross-attention and MLP, residuals added."""
    x = x + attn.cross_attention(lp["cross"], apply_norm(cfg, lp["ln2"], x),
                                 enc, **_kw(cfg))
    return x + mlp_lib.mlp(lp["mlp"], apply_norm(cfg, lp["ln3"], x),
                           activation=cfg.activation)


def _decoder_layer(cfg: ModelConfig, lp, x, enc):
    lp = cm.gathered(lp, "decoder")
    x = x + attn.self_attention(
        lp["attn"], apply_norm(cfg, lp["ln1"], x), causal=True,
        rope_theta=cfg.rope_theta, **_kw(cfg))
    return _cross_mlp(cfg, lp, x, enc)


def forward(params, batch, cfg: ModelConfig):
    """batch = {'frames': (B, enc_len, d), 'tokens': (B, S)} -> (hidden,
    aux_loss 0). With ``cfg.remat`` under grad each encoder and decoder
    layer is recomputed in the backward, as the reference's."""
    enc = encode(params, batch["frames"], cfg)
    x = _embed(params, batch["tokens"], cfg)
    for lp in _unstack(params["decoder"], cfg.n_layers):
        x = _remat(cfg, lambda x, lp: _decoder_layer(cfg, lp, x, enc))(
            x, lp)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "kv": attn.KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            length=torch.zeros((), dtype=torch.int32, device=device)),
        "enc": torch.zeros((batch, cfg.encoder_len, cfg.d_model),
                           dtype=cfg.dtype, device=device),
    }


def prefill(params, batch, cfg: ModelConfig, state):
    """Encode the frames into ``state['enc']`` and prefill the decoder's
    KV cache, in place. Returns (last-token logits (B, Vp) f32, state)."""
    enc = state["enc"]
    enc.copy_(encode(params, batch["frames"], cfg))
    x = _embed(params, batch["tokens"], cfg)
    kv = state["kv"]
    for i in range(cfg.n_layers):
        lp = cm.gathered(_layer(params["decoder"], i), "decoder")
        cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
        y, _ = attn.prefill_attention(
            lp["attn"], apply_norm(cfg, lp["ln1"], x), cache,
            rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
            **_heads_kw(cfg))
        x = _cross_mlp(cfg, lp, x + y, enc)
    kv.length.fill_(batch["tokens"].shape[1])
    h = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return _logits(params, cfg, h)[:, 0], state


def decode_step(params, tokens, cfg: ModelConfig, state):
    """One decode step. tokens (B, 1) -> (logits (B, Vp) f32, state); the
    cross K/V are recomputed from ``state['enc']``."""
    x = _embed(params, tokens, cfg)
    kv, enc = state["kv"], state["enc"]
    for i in range(cfg.n_layers):
        lp = cm.gathered(_layer(params["decoder"], i), "decoder")
        cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
        y, _ = attn.decode_attention(
            lp["attn"], apply_norm(cfg, lp["ln1"], x), cache,
            rope_theta=cfg.rope_theta, **_heads_kw(cfg))
        x = _cross_mlp(cfg, lp, x + y, enc)
    kv.length.add_(1)
    h = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0], state
