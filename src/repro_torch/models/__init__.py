"""Model zoo dispatch (port of ``repro.models``).

Families:
  dense, moe, rwkv, hybrid   -> models.lm      (decoder-only)
  encdec                     -> models.encdec  (whisper backbone)
  vlm                        -> models.vision_lm (llama-3.2-vision)

``forward`` returns (hidden, aux_loss); ``lm_loss`` (the LM head's
chunked cross-entropy, as the reference's) consumes hidden.

Batch convention: a dict with 'tokens' (B, S) plus the family's extras
('frames' (B, encoder_len, d) for encdec, 'image_embeds' (B,
n_image_tokens, d) for vlm). The engine's entry points
(``prefill_chunk``, ``verify_step``, per-slot and paged states, the
quantized KV pool, ``last_pos``, ``active``) are LM-family only, as in the
reference. Every entry point takes an explicit ``device`` where it
allocates: ``cuda`` unless the caller asks for the CPU
(``repro_torch.device.resolve_device``); ``meta`` traces shapes.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_items
from repro_torch.models import encdec, lm, vision_lm
from repro_torch.models.lm import lm_loss
from repro_torch.quant.kvcache import KVCacheDtype

_LM_FAMILIES = lm.FAMILIES


# the non-LM families: their module and its init
_OTHER = {"encdec": (encdec, encdec.init_encdec),
          "vlm": (vision_lm, vision_lm.init_vlm)}


def _other(cfg: ModelConfig):
    """The non-LM family's module (encdec or vision_lm), or raise."""
    if cfg.family not in _OTHER:
        raise ValueError(cfg.family)
    return _OTHER[cfg.family][0]


def _lm_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in _LM_FAMILIES:
        raise ValueError(f"{what} is LM-family only, not {cfg.family!r}")


def init(cfg: ModelConfig, *, seed: int = 0, device=None):
    if cfg.family in _LM_FAMILIES:
        return lm.init_lm(cfg, seed=seed, device=resolve_device(device))
    _other(cfg)  # an unknown family raises
    return _OTHER[cfg.family][1](cfg, seed=seed,
                                 device=resolve_device(device))


def axes(cfg: ModelConfig):
    """The logical sharding axes of ``init(cfg)``'s tree, leaf for leaf."""
    if cfg.family in _LM_FAMILIES:
        return lm.lm_axes(cfg)
    if cfg.family == "encdec":
        return encdec.encdec_axes(cfg)
    if cfg.family == "vlm":
        return vision_lm.vlm_axes(cfg)
    raise ValueError(cfg.family)


def forward(params, batch: dict[str, Any], cfg: ModelConfig):
    if cfg.family in _LM_FAMILIES:
        return lm.forward(params, batch["tokens"], cfg)
    return _other(cfg).forward(params, batch, cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      per_slot: bool = False,
                      kv_block_size: int | None = None,
                      num_kv_blocks: int | None = None, kv_dtype=None,
                      device=None):
    if cfg.family in _LM_FAMILIES:
        return lm.init_decode_state(cfg, batch, max_len, per_slot=per_slot,
                                    kv_block_size=kv_block_size,
                                    num_kv_blocks=num_kv_blocks,
                                    kv_dtype=kv_dtype,
                                    device=resolve_device(device))
    mod = _other(cfg)
    if KVCacheDtype.parse(kv_dtype).quantized:
        raise ValueError(f"quantized KV is LM-family paged-layout only, not "
                         f"{cfg.family!r}")
    if kv_block_size:
        raise ValueError(
            f"paged decode state is LM-family only, not {cfg.family!r}")
    if per_slot:
        raise ValueError(
            f"per-slot decode state is LM-family only, not {cfg.family!r}")
    return mod.init_decode_state(cfg, batch, max_len,
                                 device=resolve_device(device))


def prefill(params, batch: dict[str, Any], cfg: ModelConfig, state,
            last_pos=None):
    if cfg.family in _LM_FAMILIES:
        return lm.prefill(params, batch["tokens"], cfg, state,
                          last_pos=last_pos)
    mod = _other(cfg)
    if last_pos is not None:
        raise ValueError(
            f"prefill last_pos is LM-family only, not {cfg.family!r}")
    return mod.prefill(params, batch, cfg, state)


def prefill_chunk(params, tokens, cfg: ModelConfig, state, *, slot, start,
                  true_len, blocks):
    _lm_only(cfg, "chunked prefill")
    return lm.prefill_chunk(params, tokens, cfg, state, slot=slot,
                            start=start, true_len=true_len, blocks=blocks)


def decode_step(params, tokens, cfg: ModelConfig, state, active=None):
    if cfg.family in _LM_FAMILIES:
        return lm.decode_step(params, tokens, cfg, state, active=active)
    mod = _other(cfg)
    if active is not None:
        raise ValueError(
            f"per-slot active masks are LM-family only, not {cfg.family!r}")
    return mod.decode_step(params, tokens, cfg, state)


def verify_step(params, tokens, cfg: ModelConfig, state, active=None):
    _lm_only(cfg, "speculative verify")
    return lm.verify_step(params, tokens, cfg, state, active=active)


def param_count(params) -> int:
    return sum(t.numel() for _, t in tree_items(params))


__all__ = ["init", "forward", "lm_loss", "init_decode_state", "prefill",
           "prefill_chunk", "decode_step", "verify_step", "param_count"]
