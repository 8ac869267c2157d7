"""Model zoo dispatch (port of ``repro.models``): the dense, moe and rwkv
families (``models.lm.FAMILIES``); the others (hybrid, encdec, vlm) raise
NotImplementedError.

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
                      per_slot: bool = False,
                      kv_block_size: int | None = None,
                      num_kv_blocks: int | None = None, kv_dtype=None,
                      device=None):
    return lm.init_decode_state(cfg, batch, max_len, per_slot=per_slot,
                                kv_block_size=kv_block_size,
                                num_kv_blocks=num_kv_blocks,
                                kv_dtype=kv_dtype,
                                device=resolve_device(device))


def prefill(params, batch: dict[str, Any], cfg: ModelConfig, state,
            last_pos=None):
    return lm.prefill(params, batch["tokens"], cfg, state, last_pos=last_pos)


def prefill_chunk(params, tokens, cfg: ModelConfig, state, *, slot, start,
                  true_len, blocks):
    return lm.prefill_chunk(params, tokens, cfg, state, slot=slot,
                            start=start, true_len=true_len, blocks=blocks)


def decode_step(params, tokens, cfg: ModelConfig, state, active=None):
    return lm.decode_step(params, tokens, cfg, state, active=active)


def verify_step(params, tokens, cfg: ModelConfig, state, active=None):
    return lm.verify_step(params, tokens, cfg, state, active=active)


def param_count(params) -> int:
    return sum(t.numel() for _, t in tree_items(params))


__all__ = ["init", "forward", "init_decode_state", "prefill",
           "prefill_chunk", "decode_step", "verify_step", "param_count"]
