"""Model zoo dispatch (port of ``repro.models``): the dense and rwkv
families (``models.lm.FAMILIES``); the others raise NotImplementedError.

Batch convention: a dict with 'tokens' (B, S). Every entry point takes an
explicit ``device`` where it allocates: ``cuda`` unless the caller asks for
the CPU (``repro_torch.device.resolve_device``); ``meta`` traces shapes.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_items
from repro_torch.models import lm


def init(cfg: ModelConfig, *, seed: int = 0, device=None):
    return lm.init_lm(cfg, seed=seed, device=resolve_device(device))


def forward(params, batch: dict[str, Any], cfg: ModelConfig):
    return lm.forward(params, batch["tokens"], cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None):
    return lm.init_decode_state(cfg, batch, max_len,
                                device=resolve_device(device))


def prefill(params, batch: dict[str, Any], cfg: ModelConfig, state):
    return lm.prefill(params, batch["tokens"], cfg, state)


def decode_step(params, tokens, cfg: ModelConfig, state):
    return lm.decode_step(params, tokens, cfg, state)


def param_count(params) -> int:
    return sum(t.numel() for _, t in tree_items(params))


__all__ = ["init", "forward", "init_decode_state", "prefill", "decode_step",
           "param_count"]
