"""Public balanced-GEMM API (port of ``repro.core.gemm``).

``balanced_gemm(a, b)`` is the matmul every layer routes through. Plans are
solved once per (hw, M, K, N, dtypes, layout) signature and served from the
active context's :class:`PlanCache`. Dispatch is the reference's: a
decode-shaped GEMM (M <= ``SKINNY_M``, K >= 256, N >= 128) with no epilogue
goes to the GEMV kernel with the planner's (bk, bn); every other GEMM goes
to the fat kernel with the fused epilogue.

``plan_model(cfg)`` pre-solves every GEMM signature a model issues when
serving by running prefill and one decode step on the ``meta`` device (the
counterpart of ``jax.eval_shape``): every ``balanced_gemm`` resolves its
plan there, the kernel wrappers return empty meta tensors, nothing is
computed or allocated.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import balance, perfmodel as pm
from repro_torch.core.context import current_context, resolve_hw
from repro_torch.core.plancache import BalanceSnapshot, PlanCache, plan_key
from repro_torch.configs.base import dtype_name
from repro_torch.kernels import ops
from repro_torch.kernels.ops import GemmPlan

# Decode-shaped threshold: at or below this many rows the output tile cannot
# amortize weight streaming and the x-stationary GEMV kernel wins.
SKINNY_M = 128


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
    return plan


def _is_skinny(M: int, K: int, N: int) -> bool:
    """Decode-shaped: few rows, and (K, N) large enough for the GEMV
    kernel's weight-streaming design to make sense."""
    return M <= SKINNY_M and K >= 256 and N >= 128


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
    """Balanced tiled GEMM. Leading dims of ``a`` are flattened (batch)."""
    hw = resolve_hw(hw)
    *lead, K = a.shape
    M = 1
    for d in lead:
        M *= d
    N = b.shape[0] if b_layout == "col" else b.shape[1]
    a2 = a.reshape(M, K)
    if plan is None:
        plan = plan_for(M, K, N, in_dtype=a.dtype, out_dtype=out_dtype,
                        b_layout=b_layout, hw=hw)
    if (bias is None and activation in (None, "none") and out_scale is None
            and _is_skinny(M, K, N)):
        out = ops.decode_matvec(a2, b, bk=plan.bk, bn=plan.bn,
                                out_dtype=out_dtype, w_layout=b_layout, hw=hw)
    else:
        out = ops.balanced_matmul(
            a2, b, bias, plan=plan, out_dtype=out_dtype, b_layout=b_layout,
            activation=activation, out_scale=out_scale, hw=hw)
    return out.reshape(*lead, N)


def plan_model(
    cfg,
    *,
    batch: int,
    prompt_len: int,
    max_len: int,
    params: Any = None,
) -> dict[str, int]:
    """Pre-solve every GEMM plan a model config will issue when serving.

    Runs prefill (``prompt_len`` tokens) and one decode step on the meta
    device under the active context. ``params`` may be the real parameter
    tree (its shapes and dtypes are used) or None for the config's own.
    Returns 'signatures' (distinct GEMM signatures the model issues),
    'solved' (solver invocations this warm-up) and 'from_cache'.
    """
    from repro_torch import interop, models

    cache = current_context().plan_cache
    before = cache.stats.snapshot()
    if params is None:
        params = models.init(cfg, device="meta")
    else:
        params = interop.tree_map(
            lambda t: torch.empty_like(t, device="meta"), params)
    state = models.init_decode_state(cfg, batch, max_len, device="meta")
    tokens = torch.empty((batch, prompt_len), dtype=torch.int64,
                         device="meta")
    tok = torch.empty((batch, 1), dtype=torch.int64, device="meta")
    with cache.warmup():
        _, state = models.prefill(params, {"tokens": tokens}, cfg, state)
        models.decode_step(params, tok, cfg, state)
    solved = cache.stats.warm_solves - before.warm_solves
    signatures = len(cache.warm_keys)
    return {
        "signatures": signatures,
        "solved": solved,
        "from_cache": signatures - solved,
    }
