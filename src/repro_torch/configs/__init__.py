"""Architecture registry: ``get_config(arch_id)`` resolves --arch flags.

The same published configs and ``smoke()`` reduction as ``repro.configs``;
copied because the reference's ``configs/base.py`` imports ``jax.numpy``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      dtype_name, shape_applicable,
                                      torch_dtype)
from repro_torch.configs import (  # noqa: F401
    arctic_480b, command_r_plus_104b, internlm2_20b, llama3_2_vision_11b,
    nemotron_4_15b, olmoe_1b_7b, qwen1_5_4b, rwkv6_3b, whisper_base,
    zamba2_1_2b,
)

_MODULES = [
    rwkv6_3b, arctic_480b, olmoe_1b_7b, internlm2_20b, command_r_plus_104b,
    qwen1_5_4b, nemotron_4_15b, whisper_base, llama3_2_vision_11b,
    zamba2_1_2b,
]
REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name].validate()


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: small widths/depths, tiny vocab/tables."""
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = 4
    overrides = dict(
        name=cfg.name + "-smoke",
        n_layers=2, d_model=64, n_heads=n_heads,
        n_kv_heads=max(1, n_heads // min(kv_ratio, 2)),
        head_dim=16, d_ff=128, vocab_size=503,
        attn_chunk=32, loss_chunk=32, remat=False, microbatches=1,
        param_dtype="float32", activation_dtype="float32",
    )
    if cfg.family == "moe":
        overrides.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.family == "hybrid":
        overrides.update(ssm_state=16, ssm_head_dim=16, shared_attn_every=2,
                         n_kv_heads=4)
    if cfg.family == "rwkv":
        overrides.update(n_heads=4, n_kv_heads=4, head_dim=16)
    if cfg.family == "encdec":
        overrides.update(n_encoder_layers=2, encoder_len=12)
    if cfg.family == "vlm":
        overrides.update(n_layers=4, cross_attn_every=2, n_image_tokens=8)
    return dataclasses.replace(cfg, **overrides).validate()


__all__ = [
    "REGISTRY", "SHAPES", "ModelConfig", "ShapeConfig", "dtype_name",
    "get_config", "list_archs", "shape_applicable", "smoke", "torch_dtype",
]
