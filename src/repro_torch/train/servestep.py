"""Serving step factories (port of ``repro.train.servestep``): the static
server's decode, and the continuous-batching engine's decode tick, admit
and chunked prefill.

The reference compiles each step with ``jax.jit`` and donates the state;
here each ``*_fn`` is a :class:`repro_torch.train.graphs.CapturedStep`:
one CUDA graph per shape bucket on the card, replayed over the state's own
buffers, and the raw step on the CPU. The ``*_raw`` callables are the
steps themselves; the engine's plan warm-up runs them on the meta device.
Slot, chunk start, true length and the block-table row are device
tensors, not Python numbers: admissions and chunk progress replay the
same graph.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.train.graphs import CapturedStep


@dataclasses.dataclass
class ServeArtifacts:
    """``decode_fn(params, state, tokens)``: one (batch, 1) decode step,
    captured; ``prefill_fn(params, state, tokens)``: the whole-prompt
    prefill, eager (it runs once a batch)."""

    decode_fn: Callable
    prefill_fn: Callable
    decode_raw: Callable


def make_serve_step(cfg: ModelConfig, *, device) -> ServeArtifacts:
    """The static-batch server's steps, for both families."""

    def decode(params, state, tokens):
        return models.decode_step(params, tokens, cfg, state)[0]

    def prefill(params, state, tokens):
        return models.prefill(params, {"tokens": tokens}, cfg, state)[0]

    return ServeArtifacts(decode_fn=CapturedStep(decode, device),
                          prefill_fn=prefill, decode_raw=decode)


def _check_engine_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise ValueError(
            f"the {what} needs a KV-cache family (dense; moe is ROADMAP "
            f"queue 1, item 9), got {cfg.family!r}")


def _slot_admit(params, state, prompt, slot, true_len, *, cfg, prompt_pad):
    """Prefill ``prompt`` (1, prompt_pad; right-padded) into a fresh
    one-row state and copy its KV into lane ``slot`` (a 0-d int tensor)
    of the per-slot contiguous cache, in place. Returns the request's
    first-token logits (Vp,)."""
    sub = models.init_decode_state(cfg, 1, prompt_pad, device=prompt.device)
    logits, sub = models.prefill(params, {"tokens": prompt}, cfg, sub,
                                 last_pos=true_len - 1)
    kv, skv = state["kv"], sub["kv"]
    lane = slot.reshape(1).long()
    for dst, src in ((kv.k, skv.k), (kv.v, skv.v)):
        dst[:, :, :prompt_pad].index_copy_(1, lane, src)
    kv.length.index_copy_(0, lane, true_len.reshape(1).to(kv.length.dtype))
    return logits[0]


@dataclasses.dataclass
class EngineArtifacts:
    """Steps of the contiguous continuous-batching engine.

    ``decode_fn(params, state, tokens, active)``: one masked decode tick
    for all ``num_slots`` lanes; ``admit_fn(params, state, prompt, slot,
    true_len)``: a one-request prefill whose KV lands in lane ``slot``.
    """

    decode_fn: Callable
    admit_fn: Callable
    decode_raw: Callable
    admit_raw: Callable


def make_engine_step(cfg: ModelConfig, *, max_len: int, prompt_pad: int,
                     device) -> EngineArtifacts:
    """Both steps see one shape each: the tick (num_slots, 1) tokens against
    the (num_slots, max_len) per-slot cache, an admission a (1,
    prompt_pad) prompt; so each is one graph, and steady-state traffic
    issues one fixed GEMM-signature set."""
    _check_engine_family(cfg, "slot engine")
    if not 0 < prompt_pad < max_len:
        raise ValueError(
            f"need 0 < prompt_pad ({prompt_pad}) < max_len ({max_len})")

    def decode(params, state, tokens, active):
        return models.decode_step(params, tokens, cfg, state,
                                  active=active)[0]

    def admit(params, state, prompt, slot, true_len):
        return _slot_admit(params, state, prompt, slot, true_len, cfg=cfg,
                           prompt_pad=prompt_pad)

    return EngineArtifacts(decode_fn=CapturedStep(decode, device),
                           admit_fn=CapturedStep(admit, device),
                           decode_raw=decode, admit_raw=admit)


@dataclasses.dataclass
class PagedEngineArtifacts:
    """Steps of the paged engine: ``decode_fn(params, state, tokens,
    active)``, one masked tick against the block pool; ``prefill_fn(params,
    state, chunk, slot, start, true_len, blocks)``, one chunked-prefill
    step, the chunk padded to one of ``chunk_buckets`` (one graph each)."""

    decode_fn: Callable
    prefill_fn: Callable
    decode_raw: Callable
    prefill_raw: Callable
    chunk_buckets: tuple[int, ...]
    max_blocks: int


def make_paged_engine_step(cfg: ModelConfig, *, max_len: int,
                           kv_block_size: int, num_kv_blocks: int,
                           chunk_buckets: tuple[int, ...],
                           device) -> PagedEngineArtifacts:
    """Step factory for the paged (block-table) engine: the cache is a pool
    of ``num_kv_blocks`` x ``kv_block_size`` tokens (block 0 reserved), and
    admission prefill is chunked through the block table."""
    _check_engine_family(cfg, "paged engine")
    if kv_block_size < 1:
        raise ValueError(f"kv_block_size must be >= 1, got {kv_block_size}")
    if num_kv_blocks < 2:
        raise ValueError(
            f"num_kv_blocks must be >= 2 (block 0 is the reserved null "
            f"block), got {num_kv_blocks}")
    buckets = tuple(sorted({int(b) for b in chunk_buckets}))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"bad chunk_buckets {chunk_buckets!r}")
    if buckets[-1] >= max_len:
        raise ValueError(
            f"largest chunk bucket ({buckets[-1]}) must be < max_len "
            f"({max_len})")

    def decode(params, state, tokens, active):
        return models.decode_step(params, tokens, cfg, state,
                                  active=active)[0]

    def prefill_chunk(params, state, chunk, slot, start, true_len, blocks):
        return models.prefill_chunk(params, chunk, cfg, state, slot=slot,
                                    start=start, true_len=true_len,
                                    blocks=blocks)[0][0]

    return PagedEngineArtifacts(
        decode_fn=CapturedStep(decode, device),
        prefill_fn=CapturedStep(prefill_chunk, device),
        decode_raw=decode, prefill_raw=prefill_chunk,
        chunk_buckets=buckets, max_blocks=-(-max_len // kv_block_size))


__all__ = ["ServeArtifacts", "EngineArtifacts", "PagedEngineArtifacts",
           "make_serve_step", "make_engine_step", "make_paged_engine_step"]
