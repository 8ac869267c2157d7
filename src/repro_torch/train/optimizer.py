"""Optimizers: AdamW and Adafactor (factored second moment) (port of
``repro.train.optimizer``).

The reference's formulas in its order of operations: bias-corrected
``(m / c1) / (sqrt(v / c2) + eps)``, weight decay decoupled and on leaves
of two or more dims only, the warmup then inverse-sqrt schedule, the
factored second moment with its per-slice rule for a layer-stacked leaf.
``torch.optim`` is not used.

Memory: on the card the parameters, their gradients and AdamW's two f32
moments fill most of the device (qwen1.5-4b: 63.2 GB of 80). So
``update`` writes parameters and moments in place, leaf by leaf, under
``torch.no_grad()``; the gradients are clipped in place and then used as
scratch (they are consumed), and AdamW keeps at most one more temporary
the size of a leaf. The step count, learning rate and bias corrections
are 0-d tensors on the parameters' device: nothing is read back to the
host.

Sharded (``layout``, a :class:`Layout`: the mesh and the spec trees of the
parameters and of the optimizer state): each rank updates only its blocks.
The global norm sums each leaf's squares over its local block, divides out
the leaf's replication factor (the ranks that hold the same block) and
all-reduces over the world, so each distinct block counts once.
Adafactor's row and column means, and its RMS clip, over a split dim are
all-reduced over that dim's axes; its factored moments keep the
reference's layout (``trainstep.opt_spec_like``: the column vector takes
the parameter's spec positionally), and are carried into the parameter's
layout for the update and back (:func:`_reshard`). With every extent 1 the
update is the one-device update, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core import distributed as cd
from repro_torch.interop import tree_items, tree_map, tree_zip

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: str = "float32"     # adam moments / adafactor first moment
    factored_threshold: int = 2      # min ndim for factoring (adafactor)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> inverse-sqrt decay."""
    step = step.to(F32) + 1.0
    warm = step / cfg.warmup_steps
    decay = torch.sqrt(cfg.warmup_steps / step)
    return cfg.lr * torch.minimum(warm, decay)


class Layout(NamedTuple):
    """A sharded optimizer's layout: the mesh, the parameters' spec tree and
    the optimizer state's (``{"m": ..., "v": ...}``)."""

    mesh: Any
    params: Any
    opt: Any


def _spec(spec, ndim: int) -> tuple:
    """A spec padded with None to ``ndim`` entries."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def _replication(mesh, spec) -> int:
    """How many ranks hold each block of a leaf laid out by ``spec``."""
    return mesh.size // math.prod(cd.axes_extent(mesh, e) for e in spec)


def global_norm(tree, layout: Layout | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (each
    distinct block once when sharded)."""
    leaves = [torch.sum(torch.square(x), dtype=F32)
              for _, x in tree_items(tree)]
    if layout is None:
        return torch.sqrt(sum(leaves))
    mesh = layout.mesh
    reps = [_replication(mesh, s) for _, s in tree_items(layout.params)]
    total = sum(x / r if r > 1 else x for x, r in zip(leaves, reps))
    return torch.sqrt(cd.all_reduce(total, mesh, mesh.axis_names))


def clip_by_global_norm(tree, max_norm: float, layout: Layout | None = None):
    """Scale every leaf of ``tree`` in place so that the global norm is at
    most ``max_norm``. Returns (tree, the norm before clipping)."""
    norm = global_norm(tree, layout)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for _, g in tree_items(tree):
        g.mul_(scale.to(g.dtype))
    return tree, norm


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (params, grads, state, step) -> (params, state, grad norm); params
    # and state are written in place, grads consumed
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any, Any]]


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


# elements of a leaf one pass of the CPU's AdamW update takes at a time:
# its ~16 elementwise ops then run on slices the cores' caches hold (each
# op alone would stream the leaf through memory); the card's update takes
# a leaf whole
CPU_SLICE = 1 << 18


def _adamw_leaf(cfg: OptConfig, p, g, m, v, lr, c1, c2) -> None:
    """One leaf's AdamW update in place: the reference's roundings, each
    product and sum its own, with ``g`` and one temporary as scratch."""
    n = p.numel()
    span = CPU_SLICE if p.device.type == "cpu" else max(n, 1)
    decay = p.ndim >= 2  # decoupled weight decay on matrices only
    flat = [t.view(-1) for t in (p, g, m, v)]
    for lo in range(0, n, span):
        _adamw_slice(cfg, *(t[lo:lo + span] for t in flat), lr, c1, c2,
                     decay)


def _adamw_slice(cfg: OptConfig, p, g, m, v, lr, c1, c2, decay) -> None:
    g32 = g if g.dtype == F32 else g.to(F32)
    m32 = m if m.dtype == F32 else m.to(F32)
    v32 = v if v.dtype == F32 else v.to(F32)
    tmp = torch.mul(g32, 1 - cfg.b1)
    m32.mul_(cfg.b1).add_(tmp)                        # b1 m + (1 - b1) g
    torch.mul(g32, 1 - cfg.b2, out=tmp)
    tmp.mul_(g32)
    v32.mul_(cfg.b2).add_(tmp)                        # b2 v + (1 - b2) g g
    torch.div(v32, c2, out=tmp)
    tmp.sqrt_().add_(cfg.eps)                         # sqrt(v / c2) + eps
    step_ = torch.div(m32, c1, out=g32)
    step_.div_(tmp)                                   # (m / c1) / (...)
    p32 = p if p.dtype == F32 else p.to(F32)
    if decay:
        torch.mul(p32, cfg.weight_decay, out=tmp)
        step_.add_(tmp)
    del tmp
    p32.sub_(step_.mul_(lr))                          # p - lr step
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


def adamw(cfg: OptConfig, layout: Layout | None = None) -> Optimizer:
    sdt = torch_dtype(cfg.state_dtype)

    def init(params):
        zeros = lambda p: _zeros(p.shape, sdt, p)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(params, grads, state, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, layout)
        lr = schedule(cfg, step)
        t = step.to(F32) + 1.0
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        for p, g, m, v in tree_zip(params, grads, state["m"], state["v"]):
            _adamw_leaf(cfg, p, g, m, v, lr, c1, c2)
        return params, state, gnorm

    return Optimizer(init=init, update=update)


def adafactor(cfg: OptConfig, layout: Layout | None = None) -> Optimizer:
    """Factored second moment (row/col means) + bf16-able first moment."""
    sdt = torch_dtype(cfg.state_dtype)
    use_momentum = cfg.b1 > 0.0
    mesh = None if layout is None else layout.mesh

    def _factored(p):
        return p.ndim >= cfg.factored_threshold

    def init(params):
        def vstate(p):
            if _factored(p):
                return {"vr": _zeros(p.shape[:-1], F32, p),
                        "vc": _zeros(p.shape[:-2] + p.shape[-1:], F32, p)}
            return {"v": _zeros(p.shape, F32, p)}

        return {
            # classic Adafactor is momentum-free: a 1-element placeholder
            # keeps the tree structure without the O(params) buffer
            "m": tree_map(lambda p: _zeros(
                p.shape if use_momentum else (1,), sdt, p), params),
            "v": tree_map(vstate, params),
        }

    def _mean_over(m, entries):
        """A local mean ``m`` over dims laid out by ``entries``, as the mean
        over the whole dims: all-reduced over their split axes."""
        if mesh is None:
            return m
        names = [n for e in entries for n in cd.entry_axes(e)
                 if mesh.axis_size(n) > 1]
        if not names:
            return m
        return cd.all_reduce(m, mesh, names) / math.prod(
            mesh.axis_size(n) for n in names)

    def _reshard(x, src, dst):
        """``x`` laid out by ``src`` as this rank's block of ``dst``."""
        if mesh is None:
            return x
        from repro_torch.parallel import sharding as shd

        return shd.shard_leaf(shd.gather_leaf(x, src, mesh), dst, mesh)

    @torch.no_grad()
    def update(params, grads, state, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, layout)
        lr = schedule(cfg, step)
        decay = 1.0 - (step.to(F32) + 1.0) ** -0.8

        def fact_update(p, g, vr, vc, ps, vrs, vcs):
            """Factored update on one tensor (factored over the last 2
            dims): elementwise math in the parameter dtype, the second
            moment's statistics in f32 row and column vectors. ``ps``: the
            tensor's spec, ``vrs`` / ``vcs`` its moments' (padded)."""
            cdt = p.dtype if p.dtype == torch.bfloat16 else F32
            rows, cols = ps[:-1], ps[:-2] + ps[-1:]
            gc = g.to(cdt)
            sq = torch.square(gc)
            g2r = _mean_over(sq.mean(-1).to(F32), ps[-1:])
            g2c = _mean_over(sq.mean(-2).to(F32), ps[-2:-1])
            vr = _reshard(vr, vrs, rows)
            vc = _reshard(vc, vcs, cols)
            vr = decay * vr + (1 - decay) * (g2r + 1e-30)
            vc = decay * vc + (1 - decay) * (g2c + 1e-30)
            # denom = vr ⊗ vc / mean(vr)  =>  rsqrt factors stay vectors
            fr = torch.rsqrt(vr + 1e-30) * torch.sqrt(torch.clamp_min(
                _mean_over(vr.mean(-1, keepdim=True), ps[-2:-1]), 1e-30))
            fc = torch.rsqrt(vc + 1e-30)
            pre = gc * fr.to(cdt)[..., None] * fc.to(cdt)[..., None, :]
            rms = torch.sqrt(
                _mean_over(torch.square(pre).mean().to(F32), ps) + 1e-30)
            pre = pre * (1.0 / torch.clamp_min(rms, 1.0)).to(cdt)
            step_ = pre + (cfg.weight_decay * p).to(cdt)
            return (p - (lr.to(cdt) * step_).to(p.dtype),
                    _reshard(vr, rows, vrs), _reshard(vc, cols, vcs))

        def upd(p, g, m, v, pspec, vspec):
            cdt = p.dtype if p.dtype == torch.bfloat16 else F32
            ps = _spec(pspec, p.ndim)
            if _factored(p):
                vrs = _spec(vspec["vr"], p.ndim - 1)
                vcs = _spec(vspec["vc"], p.ndim - 1)
                if p.ndim >= 3 and not use_momentum:
                    # layer-stacked leaf: one layer slice at a time (the
                    # reference's lax.map): per-slice RMS clipping, the
                    # slices being separate tensors
                    for i in range(p.shape[0]):
                        new_p, vr, vc = fact_update(
                            p[i], g[i], v["vr"][i], v["vc"][i], ps[1:],
                            vrs[1:], vcs[1:])
                        p[i].copy_(new_p)
                        v["vr"][i].copy_(vr)
                        v["vc"][i].copy_(vc)
                    return
                new_p, vr, vc = fact_update(p, g, v["vr"], v["vc"], ps, vrs,
                                            vcs)
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
                if not use_momentum:
                    p.copy_(new_p)
                    return
                # momentum path recomputes via the generic formula below
                pre = (p - new_p).to(cdt) / torch.clamp_min(lr.to(cdt),
                                                            1e-30)
                step_ = cfg.b1 * m.to(cdt) + (1 - cfg.b1) * pre
                p.copy_(p - (lr.to(cdt) * step_).to(p.dtype))
                m.copy_(step_.to(sdt))
                return
            g32 = g.to(F32)
            vv = decay * v["v"] + (1 - decay) * (g32 * g32 + 1e-30)
            v["v"].copy_(vv)
            pre = (g32 * torch.rsqrt(vv + 1e-30)).to(cdt)
            rms = torch.sqrt(
                _mean_over(torch.square(pre).mean(dtype=F32), ps) + 1e-30)
            pre = pre * (1.0 / torch.clamp_min(rms, 1.0)).to(cdt)
            if use_momentum:
                step_ = cfg.b1 * m.to(cdt) + (1 - cfg.b1) * pre
                m.copy_(step_.to(sdt))
            else:
                step_ = pre
            if p.ndim >= 2:
                step_ = step_ + (cfg.weight_decay * p).to(cdt)
            p.copy_(p - (lr.to(cdt) * step_).to(p.dtype))

        specs = ((layout.params, layout.opt["v"]) if layout is not None
                 else (tree_map(lambda _: (), params),
                       tree_map(lambda _: {"vr": (), "vc": ()}, params)))
        for p, g, m, v, pspec, vspec in tree_zip(params, grads, state["m"],
                                                 state["v"], *specs):
            upd(p, g, m, v, pspec, vspec)
        return params, state, gnorm

    return Optimizer(init=init, update=update)


def make_optimizer(cfg: OptConfig, layout: Layout | None = None
                   ) -> Optimizer:
    if cfg.name == "adamw":
        return adamw(cfg, layout)
    if cfg.name == "adafactor":
        return adafactor(cfg, layout)
    raise ValueError(cfg.name)
