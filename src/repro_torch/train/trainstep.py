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
state, the port runs eagerly and writes the state in place: parameters and
optimizer moments are updated leaf by leaf (``train.optimizer``), the
gradients live in ``.grad`` during a step and are set to ``None`` after it.

With a ``mesh`` (``launch.mesh``) the step is sharded, the reference's
layout over explicit collectives:

* the state lies per rank: params by ``param_specs(models.axes(cfg))``,
  optimizer state by :func:`opt_spec_like` (Adafactor's factored row and
  column leaves included); each rank stores only its blocks;
* the batch is split over the DP axes (``batch_specs``), the microbatch
  count follows the reference's DP-aware rule (:func:`microbatch_count`);
* the forward gathers each stacked leaf's layer slice just before use and
  every other leaf once a step; the backward reduces the gradients over the
  DP axes (mean) (``parallel.fsdp``);
* over 'model' the step is tensor-parallel (Megatron's design): the
  attention and MLP blocks and the vocab-split embedding, unembedding and
  cross-entropy compute with this rank's blocks, the residual stream whole
  on every rank between layers; any other leaf is gathered whole and its
  layer computed alike on every rank of 'model', its gradient's slice
  kept;
* the MoE family runs the reference's expert parallelism
  (``layers.moe``): each rank keeps its block of the expert tables, the
  assignments travel to their expert's rank over all-to-alls over 'data'
  and back, the capacities are the reference's on that mesh, and the aux
  loss is the mean over the DP axes;
* the optimizer updates the local blocks (``train.optimizer.Layout``);
  the loss and the metrics are averaged over the DP group.

On a mesh whose every extent is 1 the sharded step is the one-device step
bit for bit. On an abstract mesh (``make_production_mesh``) it runs on the
meta device: the dry run's way of reckoning a step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as cd
from repro_torch.core.context import use_context
from repro_torch.device import resolve_device
from repro_torch.interop import tree_items, tree_map, tree_map_with_path
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass
class StepArtifacts:
    """What a launcher needs for one arch on one device."""

    step_fn: Callable            # (state, batch) -> (state, metrics)
    init_fn: Callable            # (seed=0) -> state (this rank's blocks)
    state_shapes: Any            # the whole state's tree on the meta device
    state_shardings: Any = None  # tree of sharding.NamedSharding (a mesh)
    microbatches: int = 1


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


def microbatch_count(cfg: ModelConfig, global_batch: int, dp: int = 1
                     ) -> int:
    """The reference's rule: ``cfg.microbatches`` capped so that each
    microbatch still covers every one of the ``dp`` data-parallel shards,
    lowered until microbatches x shards divide the batch."""
    M = max(1, min(cfg.microbatches, global_batch // dp))
    while global_batch % (M * dp) and M > 1:
        M -= 1
    return M


def opt_spec_like(shapes_tree, params_specs, mesh):
    """Optimizer state shards like its param: each leaf of a param's
    subtree (AdamW's moment, Adafactor's row / column vectors) takes the
    param's spec entries positionally, where the axis extent is above 1
    and divides the dim (the reference's rule, untrimmed)."""
    def per_param(spec, sub):
        def leaf_spec(x):
            ent = list(spec) + [None] * x.ndim
            out = []
            for dim, e in zip(x.shape, ent):
                n = cd.axes_extent(mesh, e)
                out.append(e if n > 1 and dim % n == 0 else None)
            return shd.P(*out)

        return tree_map(leaf_spec, sub)

    def walk(specs, sub):
        if specs is None:
            return None
        if isinstance(specs, shd.PartitionSpec):
            return per_param(specs, sub)
        if isinstance(specs, dict):
            return {k: walk(v, sub[k]) for k, v in specs.items()}
        return type(specs)(*(walk(getattr(specs, f), getattr(sub, f))
                             for f in specs._fields))

    return walk(params_specs, shapes_tree)


def _to_device(batch: dict[str, Any], device) -> dict[str, torch.Tensor]:
    """numpy or torch inputs on ``device``; token ids as int64 indices."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: opt_lib.OptConfig | None = None,
    *,
    mesh=None,
    global_batch: int = 8,
    seq_len: int = 128,
    device=None,
    grads_hook: Callable | None = None,
) -> StepArtifacts:
    """``seq_len`` is the reference's argument (its input shardings); the
    port's step takes any sequence length. ``mesh``: shard the step over
    it (the module docstring); its device is the step's (an abstract
    mesh's: meta). ``grads_hook(grads)``, if given, is called with the
    gradient tree (this rank's blocks) between the backward and the
    optimizer, which then clips and consumes it (a probe: it copies what
    it keeps)."""
    if mesh is not None and device is None:
        device = "meta" if mesh.abstract else mesh.device
    device = resolve_device(device)
    if opt_cfg is None:
        opt_cfg = default_opt_config(cfg)
    loss_fn = make_loss_fn(cfg)
    base_opt = opt_lib.make_optimizer(opt_cfg)

    def init_full(seed: int = 0, device=device):
        params = models.init(cfg, seed=seed, device=device)
        return {
            "params": params,
            "opt": base_opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    shapes = init_full(device="meta")
    if mesh is None:
        M = microbatch_count(cfg, global_batch)
        return StepArtifacts(
            step_fn=_step(loss_fn, base_opt, device, grads_hook, M),
            init_fn=init_full, state_shapes=shapes, microbatches=M)

    axes = models.axes(cfg)
    pspecs = shd.param_specs(axes, shapes["params"], mesh)
    ospecs = {k: opt_spec_like(v, pspecs, mesh)
              for k, v in shapes["opt"].items()}
    state_specs = {"params": pspecs, "opt": ospecs, "step": shd.P()}
    optimizer = opt_lib.make_optimizer(
        opt_cfg, opt_lib.Layout(mesh, pspecs, ospecs))
    dp = math.prod(mesh.axis_size(a) for a in mesh.dp_axes())
    M = microbatch_count(cfg, global_batch, dp)

    def init_fn(seed: int = 0):
        full = init_full(seed)
        return shd.shard_tree(full, state_specs, mesh)

    step = _step(loss_fn, optimizer, device, grads_hook, M,
                 sharded=(fsdp.ShardPlan(mesh, pspecs),
                          fsdp.stacked_keys(axes)))
    return StepArtifacts(step_fn=step, init_fn=init_fn, state_shapes=shapes,
                         state_shardings=shd.named_shardings(state_specs,
                                                             mesh),
                         microbatches=M)


def _step(loss_fn, optimizer, device, grads_hook, M, sharded=None):
    """The step function; ``sharded`` = (the plan, the stacked top-level
    keys) for a mesh."""
    plan, stacked = sharded if sharded is not None else (None, ())

    def train_step(state, batch):
        params = state["params"]
        leaves = [p for _, p in tree_items(params)]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        batch = _to_device(batch, device)
        view, tops = params, []
        if plan is not None:
            mesh = plan.mesh
            bspecs = shd.batch_specs(batch, mesh)
            if plan.experts and plan.dp_size > 1 and \
                    not shd.is_sharded(bspecs["tokens"], mesh):
                raise ValueError(
                    f"the MoE family over a mesh splits the batch over the "
                    f"DP axes (expert parallelism): their extent "
                    f"{plan.dp_size} must divide its "
                    f"{batch['tokens'].shape[0]} rows, as the reference's "
                    "shard_map needs")
            batch = {k: shd.shard_leaf(v, bspecs[k], mesh)
                     for k, v in batch.items()}
            # every leaf outside the layer stacks: whole once a step, a leaf
            # of its own whose gradient the microbatches accumulate, reduced
            # once at the end
            view = {}
            for k, sub in params.items():
                if k in stacked:
                    view[k] = sub
                    continue
                spec_of = dict(tree_items(plan.specs[k]))

                def whole(path, p, k=k, spec_of=spec_of):
                    spec, dim = plan.split(f"{k}/{path}" if path else k,
                                           spec_of[path])
                    if plan.trivial(spec):
                        return p if dim is None else \
                            cd.mark_model_block(p.view_as(p), dim)
                    full = shd.gather_leaf(p.detach(), spec, mesh)
                    full.requires_grad_(True)
                    tops.append((p, full, spec))
                    return full if dim is None else \
                        cd.mark_model_block(full, dim)

                view[k] = tree_map_with_path(whole, sub)
        with use_context(**({} if plan is None else
                            {"mesh": plan.mesh, "shard": plan})):
            loss, ce, aux = _accumulate(loss_fn, view, batch, M, device)
        for p, full, spec in tops:
            g = full.grad if full.grad is not None else torch.zeros_like(full)
            p.grad = fsdp.reduce_grad(g, spec, plan.mesh)
        if M > 1:
            for p in leaves:
                if p.grad is not None:
                    p.grad.div_(M)
        if plan is not None and plan.dp_size > 1:
            # the loss and the metrics: the mean over the DP group
            m = cd.all_reduce(torch.stack([loss, ce, aux]), plan.mesh,
                              plan.mesh.dp_axes()) / plan.dp_size
            loss, ce, aux = m[0], m[1], m[2]
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

    return train_step


def _accumulate(loss_fn, params, batch, M: int, device):
    """Forward and backward over ``M`` microbatches; the gradients sum in
    ``.grad`` in the parameter's dtype, as the reference's accumulator
    follows the params. Returns (loss, ce, aux), each the microbatches'
    mean, detached."""
    if M == 1:
        loss, (ce, aux) = loss_fn(params, batch)
        loss.backward()
        return loss.detach(), ce.detach(), aux.detach()
    rows = batch["tokens"].shape[0] // M
    lsum = torch.zeros((), dtype=torch.float32, device=device)
    ces, auxs = [], []
    for j in range(M):
        micro = {k: v[j * rows:(j + 1) * rows] for k, v in batch.items()}
        loss, (ce, aux) = loss_fn(params, micro)
        loss.backward()
        lsum = lsum + loss.detach()
        ces.append(ce.detach())
        auxs.append(aux.detach())
    return (lsum / M, torch.stack(ces).mean(), torch.stack(auxs).mean())


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
