"""Deterministic synthetic LM data pipeline, host-sharded and resumable
(copy of ``repro.data.synthetic``: numpy only, batches equal bit for bit).

Production posture without a corpus: batches are a pure function of
(seed, step), so (a) every host generates exactly its own shard (no I/O or
cross-host coordination), and (b) restart/elastic-reshape resume is exact —
the checkpoint stores only the step counter (ft/checkpoint.py). The
arrays stay numpy: the trainer moves them to its device.

The token stream is a mixture of Zipf-distributed unigrams and short
Markov-ish repeats so the LM loss actually decreases during the example
training runs (pure uniform noise has no learnable signal).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.35   # P(copy token from 8 positions back)


class SyntheticLM:
    """Step-indexed batch source. ``batch(step)`` is pure and deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed Zipf unigram table (clipped to vocab)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_a
        self._probs = probs / probs.sum()

    def batch(self, step: int, *, host_index: int = 0, host_count: int = 1):
        cfg = self.cfg
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide across hosts")
        per_host = cfg.global_batch // host_count
        rng = np.random.default_rng(
            (cfg.seed, step, host_index))
        toks = rng.choice(
            cfg.vocab_size, size=(per_host, cfg.seq_len + 1), p=self._probs
        ).astype(np.int32)
        # inject learnable short-range structure: repeat-8 copies
        rep = rng.random((per_host, cfg.seq_len + 1)) < cfg.repeat_p
        rep[:, :8] = False
        idx = np.arange(cfg.seq_len + 1)
        src = np.clip(idx - 8, 0, None)
        toks = np.where(rep, toks[:, src], toks)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
        }

    def batches(self, start_step: int, *, host_index=0, host_count=1):
        step = start_step
        while True:
            yield step, self.batch(
                step, host_index=host_index, host_count=host_count)
            step += 1


def batch_for(cfg: ModelConfig, seq_len: int, global_batch: int, step: int,
              seed: int = 0):
    """One-call convenience for tests/examples (adds modality stubs)."""
    src = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed))
    b = src.batch(step)
    rng = np.random.default_rng((seed, step, 7))
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (global_batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (global_batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b
