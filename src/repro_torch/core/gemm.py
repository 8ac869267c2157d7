"""Public balanced-GEMM API (port of ``repro.core.gemm``).

``balanced_gemm(a, b)`` is the matmul every layer routes through. Plans are
solved once per (hw, M, K, N, dtypes, layout) signature and served from the
active context's :class:`PlanCache`. Dispatch is the reference's: a
decode-shaped GEMM (M <= ``SKINNY_M``, K >= 256, N >= 128) with no epilogue
goes to the GEMV kernel with the planner's (bk, bn); every other GEMM goes
to the fat kernel with the fused epilogue.

Under autograd (grad mode on and ``a``, ``b`` or ``bias`` requiring grad,
on every device) the call goes through :class:`_BalancedGemm`, whose
backward runs its products through ``balanced_gemm`` too: ``dA = dC · Bᵀ``
(B read in the other layout) and ``dB = Aᵀ · dC``, so on the card the
backward launches the same hand-written kernels as the forward. The
kernels' wrappers raise rather than launch on a CUDA tensor that requires
grad: nothing is detached silently.

``checkpointed(fn, policy)`` is the remat of the training path
(``torch.utils.checkpoint``, non-reentrant): "full" recomputes every
activation in the backward, "dots" keeps the output of every product that
runs through :class:`_BalancedGemm` (the reference's
``dots_with_no_batch_dims_saveable`` under ``backend="xla"``: its
projections, the unembed, the router) and recomputes the rest.

``plan_model(cfg)`` pre-solves every GEMM signature a model issues when
serving by running prefill and one decode step on the ``meta`` device (the
counterpart of ``jax.eval_shape``): every ``balanced_gemm`` resolves its
plan there, the kernel wrappers return empty meta tensors, nothing is
computed or allocated.
"""
from __future__ import annotations

from contextvars import ContextVar
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import balance, perfmodel as pm
from repro_torch.core.context import current_context, resolve_hw, use_context
from repro_torch.core.plancache import BalanceSnapshot, PlanCache, plan_key
from repro_torch.configs.base import dtype_name
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import GemmPlan

# Decode-shaped threshold: at or below this many rows the output tile cannot
# amortize weight streaming and the x-stationary GEMV kernel wins.
SKINNY_M = 128

# Observers of plan *consultation* (distinct from the plan cache's solver
# listeners): called on every ``plan_for`` resolution, hit or miss, so an
# attribution ledger can count how often each GEMM signature is
# dispatched by a phase. fn(key, plan).
_dispatch_listeners: list = []


def add_dispatch_listener(fn) -> None:
    """Register ``fn(key, plan)`` called on every plan_for consultation."""
    _dispatch_listeners.append(fn)


def remove_dispatch_listener(fn) -> None:
    try:
        _dispatch_listeners.remove(fn)
    except ValueError:
        pass


def plan_for(
    M: int, K: int, N: int,
    *,
    in_dtype,
    out_dtype=None,
    b_layout: str = "row",
    hw: pm.HardwareSpec | str | None = None,
    cache: PlanCache | None = None,
) -> GemmPlan:
    """Fetch (or solve and cache) the balanced plan for one GEMM signature.
    A solve inside :meth:`PlanCache.warmup` counts as warm, else as lazy."""
    hw = resolve_hw(hw)
    if cache is None:
        cache = current_context().plan_cache
    key = plan_key(hw.name, M, K, N, dtype_name(in_dtype),
                   dtype_name(out_dtype or in_dtype), b_layout)
    plan = cache.get(key)
    if plan is None:
        res = balance.solve_exhaustive(
            M, K, N, hw=hw, in_dtype=in_dtype, out_dtype=out_dtype,
            b_layout=b_layout,
        )
        plan = res.plan
        step = res.chosen_step
        cache.put(key, plan,
                  balance=None if step is None else BalanceSnapshot(
                      t_comp=step.t_comp, t_mem=step.t_mem))
    if _dispatch_listeners:
        for fn in _dispatch_listeners:
            fn(key, plan)
    return plan


def clear_plan_cache() -> None:
    """Clear the active context's plan cache (entries and counters)."""
    current_context().plan_cache.clear()


def _is_skinny(M: int, K: int, N: int) -> bool:
    """Decode-shaped: few rows, and (K, N) large enough for the GEMV
    kernel's weight-streaming design to make sense."""
    return M <= SKINNY_M and K >= 256 and N >= 128


def _dispatch(a2, b, bias, *, out_dtype, b_layout, activation, out_scale,
              plan, hw) -> torch.Tensor:
    """One (M, K) x B product: the GEMV when decode-shaped with float
    inputs and no epilogue, else the fat kernel with the fused epilogue
    (every int8 product: a W8A8 row-parallel block's int32 partials too)."""
    M, K = a2.shape
    N = b.shape[0] if b_layout == "col" else b.shape[1]
    if plan is None:
        plan = plan_for(M, K, N, in_dtype=a2.dtype, out_dtype=out_dtype,
                        b_layout=b_layout, hw=hw)
    if (bias is None and activation in (None, "none") and out_scale is None
            and a2.is_floating_point() and _is_skinny(M, K, N)):
        return ops.decode_matvec(a2, b, bk=plan.bk, bn=plan.bn,
                                 out_dtype=out_dtype, w_layout=b_layout,
                                 hw=hw)
    return ops.balanced_matmul(
        a2, b, bias, plan=plan, out_dtype=out_dtype, b_layout=b_layout,
        activation=activation, out_scale=out_scale, hw=hw)


def _activation_grad(pre: torch.Tensor, activation: str,
                     dc: torch.Tensor) -> torch.Tensor:
    """``dC · act'(pre)`` in f32: the f32 cotangent of the output cast,
    then the activation's derivative (``ref.apply_activation``'s)."""
    with torch.enable_grad():
        p = pre.detach().requires_grad_(True)
        y = ref.apply_activation(p, activation)
        (d,) = torch.autograd.grad(y, p, dc.to(torch.float32))
    return d


class _Products:
    """``remat_policy="dots"``: the outputs of the balanced GEMMs of one
    checkpointed call, recorded in its forward and handed back, in call
    order, to its recompute, which then launches none of them. The two
    contexts are ``torch.utils.checkpoint``'s ``context_fn``; the
    recompute's may be entered more than once (each starts from the
    first product)."""

    def __init__(self):
        self.saved = []     # (output, its version, its plan) in call order
        self.next = None    # None: recording; else the next to hand back

    def contexts(self):
        return _Taping(self, replay=False), _Taping(self, replay=True)

    def take(self):
        out, version, plan = self.saved[self.next]
        if out._version != version:
            raise RuntimeError(
                "remat_policy='dots': a product's output was written in "
                "place after its forward; its recompute would read that")
        self.next += 1
        return out.detach(), plan


_PRODUCTS: ContextVar[_Products | None] = ContextVar("gemm_products",
                                                     default=None)


class _Taping:
    def __init__(self, products: _Products, replay: bool):
        self.products, self.replay, self.tokens = products, replay, []

    def __enter__(self):
        if self.replay:
            self.products.next = 0
        self.tokens.append(_PRODUCTS.set(self.products))

    def __exit__(self, *exc):
        _PRODUCTS.reset(self.tokens.pop())


REMAT_POLICIES = ("full", "dots")


def checkpointed(fn, policy: str = "full"):
    """``fn`` whose activations are recomputed in the backward instead of
    kept (``torch.utils.checkpoint``, non-reentrant, as ``jax.checkpoint``).
    ``policy`` "dots" keeps the balanced GEMMs' outputs (:class:`_Products`)
    and recomputes the rest; FSDP's gathers (``cm.gathered`` inside ``fn``)
    run again either way, as the products save their gathered operands.
    The forward draws no random numbers, so no RNG state is stashed. The
    recompute runs under the forward's GEMM context: autograd runs the
    backward of CUDA tensors on a device thread of its own, which the
    context variable does not reach."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={policy!r}: one of {REMAT_POLICIES}")
    gemm_context = current_context()

    def run(*args):
        with use_context(gemm_context):
            return fn(*args)

    def call(*args):
        kw = {"context_fn": _Products().contexts} if policy == "dots" else {}
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return call


class _BalancedGemm(torch.autograd.Function):
    """``act(A @ B + bias)`` whose backward is balanced GEMMs as well.

    Forward: exactly :func:`_dispatch`. Backward, in the reference's AD
    order: with an activation, the pre-activation is recomputed by the fat
    kernel with no epilogue and f32 out, and ``d_pre = dC · act'(pre)`` in
    f32; without one ``d_pre`` is ``dC`` as it comes (bf16 for a bf16
    output, f32 for an f32 one). Then ``d_bias = Σ d_pre`` in f32,
    ``dA = d_pre · Bᵀ`` (B in the other layout: a (K, N) row B read as an
    (N', K') = (K, N) col one, a col B as a row one) and ``dB = Aᵀ ·
    d_pre`` (a col B's (N, K) gradient as ``d_preᵀ · A``), each through
    :func:`balanced_gemm`, its plan from the cache like any other. The
    backward runs under the forward's GEMM context: autograd runs the
    backward of CUDA tensors on a device thread of its own, which the
    context variable does not reach. Inside a "dots" remat
    (:func:`checkpointed`) the forward records its output and plan, and
    the recompute takes them back instead of launching."""

    @staticmethod
    def forward(ctx, a2, b, bias, out_dtype, b_layout, activation, plan, hw):
        products = _PRODUCTS.get()
        if products is not None and products.next is not None:
            out, plan = products.take()
        else:
            if plan is None:
                # solved here, not in _dispatch, so that the backward's
                # recompute runs the forward's plan (not an unsolved
                # default whose tile may not fit the route's shared memory)
                plan = plan_for(
                    a2.shape[0], a2.shape[1],
                    b.shape[0] if b_layout == "col" else b.shape[1],
                    in_dtype=a2.dtype, out_dtype=out_dtype,
                    b_layout=b_layout, hw=hw)
            out = _dispatch(a2, b, bias, out_dtype=out_dtype,
                            b_layout=b_layout, activation=activation,
                            out_scale=None, plan=plan, hw=hw)
            if products is not None:
                products.saved.append((out.detach(), out._version, plan))
        ctx.save_for_backward(a2, b, bias)
        ctx.args = (b_layout, activation, plan, hw)
        ctx.gemm_context = current_context()
        return out

    @staticmethod
    def backward(ctx, dc):
        with use_context(ctx.gemm_context):
            return _BalancedGemm._backward(ctx, dc)

    @staticmethod
    def _backward(ctx, dc):
        a, b, bias = ctx.saved_tensors
        b_layout, activation, plan, hw = ctx.args
        if activation in (None, "none"):
            d_pre = dc.contiguous()
        else:
            if _dispatch_listeners:
                # the recompute takes the forward's plan, not the cache's:
                # its listeners still see the product (the dry run counts it)
                N = b.shape[0] if b_layout == "col" else b.shape[1]
                key = plan_key(hw.name, a.shape[0], a.shape[1], N,
                               dtype_name(a.dtype), "float32", b_layout)
                for fn in _dispatch_listeners:
                    fn(key, plan)
            pre = ops.balanced_matmul(a, b, bias, plan=plan,
                                      out_dtype=torch.float32,
                                      b_layout=b_layout, hw=hw)
            d_pre = _activation_grad(pre, activation, dc)
            del pre
        need_a, need_b, need_bias = ctx.needs_input_grad[:3]
        da = db = d_bias = None
        if need_bias and bias is not None:
            d_bias = d_pre.sum(0, dtype=torch.float32).to(bias.dtype)
        if need_a:
            da = balanced_gemm(d_pre, b, out_dtype=a.dtype, hw=hw,
                               b_layout="row" if b_layout == "col" else "col")
        if need_b:
            if b_layout == "col":
                db = balanced_gemm(d_pre.t().contiguous(), a,
                                   out_dtype=b.dtype, hw=hw)
            else:
                db = balanced_gemm(a.t().contiguous(), d_pre,
                                   out_dtype=b.dtype, hw=hw)
        return da, db, d_bias, None, None, None, None, None


def balanced_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    out_dtype: torch.dtype | None = None,
    b_layout: str = "row",
    activation: str | None = None,
    out_scale: torch.Tensor | None = None,
    plan: GemmPlan | None = None,
    hw: pm.HardwareSpec | str | None = None,
) -> torch.Tensor:
    """Balanced tiled GEMM. Leading dims of ``a`` are flattened (batch).
    Differentiable in ``a``, ``b`` and ``bias`` (:class:`_BalancedGemm`),
    except with ``out_scale``: the int8 path does not train."""
    hw = resolve_hw(hw)
    *lead, K = a.shape
    M = 1
    for d in lead:
        M *= d
    N = b.shape[0] if b_layout == "col" else b.shape[1]
    a2 = a.reshape(M, K)
    if out_dtype is None:
        out_dtype = a.dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, bias)):
        if out_scale is not None:
            raise ValueError("balanced_gemm has no gradient through "
                             "out_scale (the int8 path): call it without "
                             "grad")
        out = _BalancedGemm.apply(a2, b, bias, out_dtype, b_layout,
                                  activation, plan, hw)
    else:
        out = _dispatch(a2, b, bias, out_dtype=out_dtype, b_layout=b_layout,
                        activation=activation, out_scale=out_scale,
                        plan=plan, hw=hw)
    return out.reshape(*lead, N)


def plan_model(
    cfg,
    *,
    batch: int,
    prompt_len: int,
    max_len: int,
    params: Any = None,
    extras: dict[str, Any] | None = None,
    mesh: Any = None,
) -> dict[str, int]:
    """Pre-solve every GEMM plan a model config will issue when serving.

    Runs prefill (``prompt_len`` tokens) and one decode step on the meta
    device under the active context. ``params`` may be the real parameter
    tree (its shapes and dtypes are used) or None for the config's own;
    ``extras`` the prefill batch's other inputs (encdec's ``frames``, vlm's
    ``image_embeds``), of which only the shapes and dtypes are used. Over
    a ``mesh`` the steps are the sharded serve steps
    (``train.servestep.make_serve_step``) on an abstract copy of it, at
    this rank's local shapes: ``params`` (or the config's own, sharded)
    are its blocks.
    Returns 'signatures' (distinct GEMM signatures the model issues),
    'solved' (solver invocations this warm-up) and 'from_cache'.
    """
    from repro_torch import interop, models

    cache = current_context().plan_cache
    before = cache.stats.snapshot()
    art = None
    if mesh is not None:
        from repro_torch.train.servestep import make_serve_step

        art = make_serve_step(
            cfg, device="meta", mesh=mesh.as_abstract(),
            quantized=params is not None and interop.is_quantized(params),
            batch=batch, max_len=max_len)
    if params is None:
        params = models.init(cfg, device="meta")
        if art is not None:
            params = art.shard_params(params)
    else:
        params = interop.tree_map(
            lambda t: torch.empty_like(t, device="meta"), params)
    inputs = {"tokens": torch.empty((batch, prompt_len), dtype=torch.int64,
                                    device="meta")}
    for k, v in (extras or {}).items():
        inputs[k] = torch.empty_like(v, device="meta")
    tok = torch.empty((batch, 1), dtype=torch.int64, device="meta")
    with cache.warmup():
        if art is None:
            state = models.init_decode_state(cfg, batch, max_len,
                                             device="meta")
            _, state = models.prefill(params, inputs, cfg, state)
            models.decode_step(params, tok, cfg, state)
        else:
            state = art.init_state(batch, max_len)
            art.prefill_fn(params, state, art.rows(inputs))
            art.decode_raw(params, state, art.rows({"t": tok})["t"])
    solved = cache.stats.warm_solves - before.warm_solves
    signatures = len(cache.warm_keys)
    return {
        "signatures": signatures,
        "solved": solved,
        "from_cache": signatures - solved,
    }
