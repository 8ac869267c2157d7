"""Vision-LM backbone, llama-3.2-vision-11b (port of
``repro.models.vision_lm``).

The vision tower is a stub, as in the reference: the batch carries
precomputed patch embeddings ``image_embeds`` (B, n_image_tokens, d). The
text backbone groups its layers as G = n_layers / cross_attn_every groups
of (cross_attn_every - 1) self-attention layers and one gated
cross-attention layer, so the parameter tree has two stacked levels:
``groups.self`` leaves are (G, n_self, ...), ``groups.cross`` leaves (G,
...), and the tanh gates ``gate_attn`` / ``gate_mlp`` are (G,) in the
param dtype, zeros at init (a cross layer then adds exactly nothing). The
reference's two-level ``lax.scan`` becomes Python loops over the layers
in its order, each layer a view of its slice of the stacked leaves
(``_stack_layer``; the forward recomputes each group under remat, as the
reference's ``group_body``). Every decode step recomputes the cross K/V from
``img``, as the reference does.

The decode state is the self layers' contiguous KV cache (G, n_self, B,
S_max, Hkv, Dh) with a 0-d length, and ``img`` (B, n_image_tokens, d) in
the activation dtype: prefill writes both in place, so a decode step
captured as a CUDA graph reads the image embeddings from the same buffer
at every replay.
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


def group_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, n_self_per_group)."""
    if cfg.cross_attn_every < 1 or cfg.n_layers % cfg.cross_attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of cross_attn_every "
                         f"{cfg.cross_attn_every}")
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def init_vlm(cfg: ModelConfig, *, seed: int = 0, device) -> dict[str, Any]:
    """Random weights with the reference's tree, shapes and dtypes, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``; the
    gates are zeros, as the reference's."""
    cfg.validate()
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d, dt = cfg.d_model, cfg.pdtype
    G, n_self = group_dims(cfg)
    norm = lambda lead: init_norm(cfg, d, lead=lead, device=device)
    a_init = lambda lead: attn.init_attn(
        gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        qkv_bias=cfg.qkv_bias, dtype=dt, lead=lead, device=device)
    m_init = lambda lead: mlp_lib.init_mlp(
        gen, d, cfg.d_ff, gated=cfg.gated_mlp, dtype=dt, lead=lead,
        device=device)
    two, one = (G, n_self), (G,)
    return {
        "embed": cm.normal_init(gen, (cfg.padded_vocab, d), dt, scale=0.02,
                                device=device),
        "unembed": cm.normal_init(gen, (d, cfg.padded_vocab), dt,
                                  device=device),
        "final_norm": init_norm(cfg, d, device=device),
        "groups": {
            "self": {"ln1": norm(two), "ln2": norm(two),
                     "attn": a_init(two), "mlp": m_init(two)},
            "cross": {"ln1": norm(one), "ln2": norm(one),
                      "attn": a_init(one), "mlp": m_init(one),
                      "gate_attn": torch.zeros(one, dtype=dt, device=device),
                      "gate_mlp": torch.zeros(one, dtype=dt, device=device)},
        },
    }


def _kw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, chunk=cfg.attn_chunk)


def vlm_axes(cfg: ModelConfig):
    """The logical sharding axes of :func:`init_vlm`'s tree: the self
    layers' leaves carry two stacked levels (groups, per-group)."""
    def pp(tree):
        return _prefix_axes(_prefix_axes(tree))

    return {
        "embed": ("vocab", None),
        "unembed": (None, "vocab"),
        "final_norm": norm_axes(cfg),
        "groups": {
            "self": {
                "ln1": pp(norm_axes(cfg)), "ln2": pp(norm_axes(cfg)),
                "attn": pp(attn.attn_axes(cfg.qkv_bias)),
                "mlp": pp(mlp_lib.mlp_axes(cfg.gated_mlp)),
            },
            "cross": {
                "ln1": _prefix_axes(norm_axes(cfg)),
                "ln2": _prefix_axes(norm_axes(cfg)),
                "attn": _prefix_axes(attn.attn_axes(cfg.qkv_bias)),
                "mlp": _prefix_axes(mlp_lib.mlp_axes(cfg.gated_mlp)),
                "gate_attn": ("layers",), "gate_mlp": ("layers",),
            },
        },
    }


def _self_block(cfg: ModelConfig, lp, x, mode: str = "full", cache=None):
    """A self-attention layer: "full" (no cache), "prefill" (writes the
    cache's prefix in place) or "decode" (one token, written at the
    cache's length)."""
    h = apply_norm(cfg, lp["ln1"], x)
    if mode == "full":
        y = attn.self_attention(lp["attn"], h, rope_theta=cfg.rope_theta,
                                **_kw(cfg))
    elif mode == "prefill":
        y, _ = attn.prefill_attention(lp["attn"], h, cache,
                                      rope_theta=cfg.rope_theta,
                                      chunk=cfg.attn_chunk, **_heads_kw(cfg))
    else:
        y, _ = attn.decode_attention(lp["attn"], h, cache,
                                     rope_theta=cfg.rope_theta,
                                     **_heads_kw(cfg))
    x = x + y
    return x + mlp_lib.mlp(lp["mlp"], apply_norm(cfg, lp["ln2"], x),
                           activation=cfg.activation)


def _gate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """tanh of a 0-d gate in the param dtype, then cast to x's dtype, as
    ``jnp.tanh(gate).astype(x.dtype)``."""
    return torch.tanh(g).to(x.dtype)


def _cross_block(cfg: ModelConfig, gp, x, img):
    """The gated cross-attention layer (llama-3.2: tanh-gated residuals);
    the product and the residual in the activation dtype."""
    y = attn.cross_attention(gp["attn"], apply_norm(cfg, gp["ln1"], x), img,
                             **_kw(cfg))
    x = x + _gate(gp["gate_attn"], x) * y
    y2 = mlp_lib.mlp(gp["mlp"], apply_norm(cfg, gp["ln2"], x),
                     activation=cfg.activation)
    return x + _gate(gp["gate_mlp"], x) * y2


def _stack_layer(params, cfg: ModelConfig, i: int, x, img, mode="full",
                 kv=None):
    """Layer ``i`` of the stack in the reference's order (each group's
    self layers, then its cross layer): group g = i // cross_attn_every,
    its self layer j or, at j = cross_attn_every - 1, its cross layer. A
    self layer in "prefill" or "decode" mode writes its slice of the KV
    cache ``kv`` in place."""
    g, j = divmod(i, cfg.cross_attn_every)
    if j == cfg.cross_attn_every - 1:
        return _cross_block(cfg, cm.gathered(
            _layer(params["groups"]["cross"], g), "groups/cross"), x, img)
    cache = None if kv is None else attn.KVCache(
        k=kv.k[g, j], v=kv.v[g, j], length=kv.length)
    return _self_block(cfg, cm.gathered(
        _layer(params["groups"]["self"], (g, j)), "groups/self", 2), x,
        mode, cache)


def _group(cfg: ModelConfig, gp_self, gp_cross, x, img):
    """One group, the reference's ``group_body``: its self layers
    (``gp_self``'s leaves (n_self, ...)), then its cross layer, each layer
    gathered inside the remat boundary."""
    for lp in _unstack(gp_self, cfg.cross_attn_every - 1):
        x = _self_block(cfg, cm.gathered(lp, "groups/self", 2), x)
    return _cross_block(cfg, cm.gathered(gp_cross, "groups/cross"), x, img)


def forward(params, batch, cfg: ModelConfig):
    """batch = {'tokens': (B, S), 'image_embeds': (B, n_img, d)} ->
    (hidden, aux_loss 0). With ``cfg.remat`` under grad each group is
    recomputed in the backward (the reference's remat of ``group_body``)."""
    G, _ = group_dims(cfg)
    img = batch["image_embeds"].to(cfg.dtype)
    x = _embed(params, batch["tokens"], cfg)
    groups = zip(_unstack(params["groups"]["self"], G),
                 _unstack(params["groups"]["cross"], G))
    for gp_self, gp_cross in groups:
        x = _remat(cfg, lambda x, s, c: _group(cfg, s, c, x, img))(
            x, gp_self, gp_cross)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device):
    G, n_self = group_dims(cfg)
    shape = (G, n_self, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "kv": attn.KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            length=torch.zeros((), dtype=torch.int32, device=device)),
        "img": torch.zeros((batch, cfg.n_image_tokens, cfg.d_model),
                           dtype=cfg.dtype, device=device),
    }


def _run_cached(params, x, cfg: ModelConfig, state, mode: str):
    """Every layer in order: the self layers against their caches (written
    in place), the cross layers against ``state['img']``."""
    for i in range(cfg.n_layers):
        x = _stack_layer(params, cfg, i, x, state["img"], mode, state["kv"])
    return x


def prefill(params, batch, cfg: ModelConfig, state):
    """Copy the image embeddings into ``state['img']`` and prefill the KV
    cache, in place. Returns (last-token logits (B, Vp) f32, state)."""
    state["img"].copy_(batch["image_embeds"].to(cfg.dtype))
    x = _embed(params, batch["tokens"], cfg)
    x = _run_cached(params, x, cfg, state, "prefill")
    state["kv"].length.fill_(batch["tokens"].shape[1])
    h = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return _logits(params, cfg, h)[:, 0], state


def decode_step(params, tokens, cfg: ModelConfig, state):
    """One decode step. tokens (B, 1) -> (logits (B, Vp) f32, state); the
    cross K/V are recomputed from ``state['img']``."""
    x = _embed(params, tokens, cfg)
    x = _run_cached(params, x, cfg, state, "decode")
    state["kv"].length.add_(1)
    h = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0], state
