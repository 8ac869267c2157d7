"""Training step factory (port of ``repro.train.trainstep``).

One step: forward, the chunked cross-entropy and the aux loss, the
backward, then the optimizer, with gradient accumulation over
``cfg.microbatches`` splits of the batch. Every projection of the forward
and of the backward goes through ``core.gemm.balanced_gemm``: on the card
the hand-written GEMM kernels, forward (the fat kernel with its fused
epilogue, the GEMV where decode-shaped) and backward (``dA`` and ``dB``,
and the recomputed pre-activation of an activation epilogue). With
``cfg.remat`` each layer is recomputed in the backward.

Where the reference jit-compiles one sharded function that donates its
state, the port runs eagerly on one device and writes the state in place:
parameters and optimizer moments are updated leaf by leaf
(``train.optimizer``), the gradients live in ``.grad`` during a step and
are set to ``None`` after it. Distribution (the reference's shardings) is
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_items, tree_map
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass
class StepArtifacts:
    """What a launcher needs for one arch on one device."""

    step_fn: Callable            # (state, batch) -> (state, metrics)
    init_fn: Callable            # (seed=0) -> state
    state_shapes: Any            # the state's tree on the meta device


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        hidden, aux = models.forward(params, batch, cfg)
        ce = models.lm_loss(params, hidden, batch["labels"], cfg)
        return ce + aux, (ce, aux)

    return loss_fn


def default_opt_config(cfg: ModelConfig) -> opt_lib.OptConfig:
    """The reference's choice: AdamW with f32 moments, or classic
    (momentum-free) Adafactor with a bf16 first moment for the giants."""
    return opt_lib.OptConfig(
        name=cfg.optimizer,
        b1=0.0 if cfg.optimizer == "adafactor" else 0.9,
        state_dtype="bfloat16" if cfg.optimizer == "adafactor"
        else "float32",
    )


def microbatch_count(cfg: ModelConfig, global_batch: int) -> int:
    """The reference's rule on one data-parallel shard: ``cfg.microbatches``
    capped by the batch, lowered until it divides the batch."""
    M = max(1, min(cfg.microbatches, global_batch))
    while global_batch % M and M > 1:
        M -= 1
    return M


def _to_device(batch: dict[str, Any], device) -> dict[str, torch.Tensor]:
    """numpy or torch inputs on ``device``; token ids as int64 indices."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: opt_lib.OptConfig | None = None,
    *,
    global_batch: int = 8,
    seq_len: int = 128,
    device=None,
    grads_hook: Callable | None = None,
) -> StepArtifacts:
    """``seq_len`` is the reference's argument (its input shardings); the
    port's step takes any sequence length. ``grads_hook(grads)``, if given,
    is called with the gradient tree between the backward and the
    optimizer, which then clips and consumes it (a probe: it copies what
    it keeps)."""
    device = resolve_device(device)
    if opt_cfg is None:
        opt_cfg = default_opt_config(cfg)
    optimizer = opt_lib.make_optimizer(opt_cfg)
    loss_fn = make_loss_fn(cfg)
    M = microbatch_count(cfg, global_batch)

    def init_state(seed: int = 0, device=device):
        params = models.init(cfg, seed=seed, device=device)
        return {
            "params": params,
            "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def train_step(state, batch):
        params = state["params"]
        leaves = [p for _, p in tree_items(params)]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        batch = _to_device(batch, device)
        if M > 1:
            # gradient accumulation: .grad sums in the parameter's dtype,
            # as the reference's accumulator follows the params
            rows = batch["tokens"].shape[0] // M
            lsum = torch.zeros((), dtype=torch.float32, device=device)
            ces, auxs = [], []
            for j in range(M):
                micro = {k: v[j * rows:(j + 1) * rows]
                         for k, v in batch.items()}
                loss, (ce, aux) = loss_fn(params, micro)
                loss.backward()
                lsum = lsum + loss.detach()
                ces.append(ce.detach())
                auxs.append(aux.detach())
            loss, ce, aux = (lsum / M, torch.stack(ces).mean(),
                             torch.stack(auxs).mean())
            for p in leaves:
                if p.grad is not None:
                    p.grad.div_(M)
        else:
            loss, (ce, aux) = loss_fn(params, batch)
            loss.backward()
            loss, ce, aux = loss.detach(), ce.detach(), aux.detach()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        if grads_hook is not None:
            grads_hook(grads)
        _, opt_state, gnorm = optimizer.update(params, grads, state["opt"],
                                               state["step"])
        del grads
        for p in leaves:
            p.grad = None
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm,
                   "step": state["step"]}
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return StepArtifacts(step_fn=train_step, init_fn=init_state,
                         state_shapes=init_state(device="meta"))


def input_shapes(cfg: ModelConfig, batch: int, seq: int
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """One training batch: each input's (shape, dtype)."""
    out = {"tokens": ((batch, seq), torch.int32),
           "labels": ((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = ((batch, cfg.encoder_len, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        out["image_embeds"] = ((batch, cfg.n_image_tokens, cfg.d_model),
                               cfg.dtype)
    return out
