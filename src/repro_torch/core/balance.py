"""Balanced-point tile optimization — the paper's §4.5 (port of
``repro.core.balance``).

Three solvers:

``solve_single_core``  (§4.5.1)
    Exhaustive IP over (bm, bk, bn) subject to the fast-memory capacity
    constraint (Eq. 5) and the compute-bound constraint (Eq. 4). Primary
    objective: maximize MACs ``bm·bk·bn`` (data reuse); secondary: minimize
    ``bm·bn``. This yields the compute-optimal kernel, which the paper then
    shows is memory-bound end to end (§5.2.1).

``solve_balanced``  (§4.5.2)
    The system-level walk: start from the single-core solution, then
    repeatedly *decrease bk* and re-solve the IP with bk fixed and the
    objective flipped to maximize ``bm·bn`` (cutting Eqs. 6-7 DRAM
    traffic), stopping after three probes that do not improve: the best
    iterate is the balanced point T_comp ≈ T_mem. ``measure_fn(plan)``
    replaces the model with a measurement (the autotuner's on-card
    procedure).

``solve_exhaustive``
    Evaluates the modeled end-to-end time of every feasible tile (what the
    planner uses: with a model the full sweep is free).

What the solvers may choose is a property of the hardware: the candidate
tiles and the working-set model come from ``HardwareSpec.candidate_blocks``
and ``HardwareSpec.working_set``. Under a TPU spec they are exactly the
reference's (``balance.candidate_blocks`` and the VMEM model of
``kernels/matmul.vmem_bytes``), so plans and walks agree one for one;
under ``h100`` they are the tiles ``csrc/matmul.cu`` is built for on the
GEMM's route (``HardwareSpec.gemm_route``) and that route's shared memory,
so the walk steps bk by ``kernels.matmul.BK_STEP`` and does not move on a
tensor-core route, whose bk is fixed (``TC_BK``).

The KV-traffic model (``kv_bytes_per_token``, ``decode_kv_traffic``) is the
memory side of a paged decode-attention step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import perfmodel as pm
from repro_torch.core.context import resolve_hw
from repro_torch.kernels.ops import GemmPlan
from repro_torch.quant.kvcache import KVCacheDtype


def _route(hw: pm.HardwareSpec, M: int | None, in_dtype, b_layout: str):
    """The GPU route a tile is for; without M, a GEMM with many rows (the
    compute-bound case of the single-core solve). None on a TPU."""
    return hw.gemm_route(1 << 20 if M is None else M, in_dtype, b_layout)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    plan: GemmPlan
    eff: float              # modeled kernel efficiency
    macs: int               # bm·bk·bn, the §4.5.1 primary objective
    vmem: int               # Eq. 5 working set, bytes
    compute_bound: bool     # Eq. 4 satisfied


def solve_single_core(
    *,
    hw: pm.HardwareSpec | str | None = None,
    in_dtype=torch.bfloat16,
    out_dtype=None,
    b_layout: str = "row",
    vmem_budget: int | None = None,
    route: str | None = None,
) -> SolveResult:
    """§4.5.1: the compute-optimal kernel (max MACs, then min bm·bn).
    ``route``: on a GPU spec, the kernel route (default: the route of a
    GEMM with many rows)."""
    hw = resolve_hw(hw)
    if out_dtype is None:
        out_dtype = in_dtype
    if route is None:
        route = _route(hw, None, in_dtype, b_layout)
    ty_in = pm.itemsize(in_dtype)
    ty_out = pm.itemsize(out_dtype)
    budget = vmem_budget or hw.vmem_bytes
    bms, bks, bns = hw.candidate_blocks(ty_in, route)

    best: tuple | None = None
    fallback: tuple | None = None  # best tile ignoring Eq. 4 (tiny budgets)
    for bm in bms:
        for bn in bns:
            for bk in bks:
                v = hw.working_set(bm, bk, bn, ty_in, ty_out, route)
                if v > budget:
                    break  # bk ascending: larger only grows v
                key = (bm * bk * bn, -(bm * bn))  # max MACs, then min bm·bn
                if fallback is None or key > fallback[0]:
                    fallback = (key, bm, bk, bn, v)
                bt = pm.block_times(hw, bm, bk, bn, in_dtype=in_dtype,
                                    b_layout=b_layout, route=route)
                if not bt.compute_bound:  # Eq. 4
                    continue
                if best is None or key > best[0]:
                    best = (key, bm, bk, bn, v)
    compute_bound = best is not None
    if best is None:
        # no compute-bound tile fits (small budgets, or a route whose
        # tiles are all memory-bound): the max-MACs tile, still the
        # paper's primary objective
        best = fallback
    if best is None:
        raise ValueError(f"no tile of {hw.name} fits the {budget}-byte "
                         "working-set budget")
    _, bm, bk, bn, v = best
    eff = pm.kernel_efficiency(hw, bm, bk, bn, in_dtype=in_dtype,
                               b_layout=b_layout, route=route)
    return SolveResult(
        plan=GemmPlan(bm=bm, bk=bk, bn=bn), eff=eff, macs=bm * bk * bn,
        vmem=v, compute_bound=compute_bound,
    )


def _solve_fixed_bk(
    bk: int,
    *,
    hw: pm.HardwareSpec,
    ty_in: int,
    ty_out: int,
    in_dtype,
    b_layout: str,
    budget: int,
    route: str | None = None,
) -> GemmPlan | None:
    """Inner IP of the §4.5.2 walk: bk fixed, maximize bm·bn."""
    bms, _, bns = hw.candidate_blocks(ty_in, route)
    best = None
    for bm in bms:
        for bn in bns:
            if hw.working_set(bm, bk, bn, ty_in, ty_out, route) > budget:
                continue
            bt = pm.block_times(hw, bm, bk, bn, in_dtype=in_dtype,
                                b_layout=b_layout, route=route)
            if not bt.compute_bound:
                continue
            key = (bm * bn, bm * bk * bn)
            if best is None or key > best[0]:
                best = (key, bm, bn)
    if best is None:
        return None
    _, bm, bn = best
    return GemmPlan(bm=bm, bk=bk, bn=bn)


@dataclasses.dataclass(frozen=True)
class BalanceStep:
    """One evaluated plan with its modeled (or measured) times."""

    plan: GemmPlan
    t_comp: float
    t_mem: float
    t_total: float
    tops: float


@dataclasses.dataclass(frozen=True)
class BalanceResult:
    plan: GemmPlan
    steps: list[BalanceStep]
    tops: float

    @property
    def chosen_step(self) -> BalanceStep | None:
        """The recorded step the returned plan came from."""
        for s in self.steps:
            if s.plan == self.plan:
                return s
        return None

    def is_balanced(self, tol: float = 0.25) -> bool:
        """Whether the chosen point balances compute and memory: the two
        streams within ``tol`` relative difference. A GEMM pinned to one
        wall (a skinny decode GEMM is memory-bound at every tile) reports
        False."""
        s = self.chosen_step
        if s is None:
            return False
        hi = max(s.t_comp, s.t_mem)
        lo = min(s.t_comp, s.t_mem)
        return hi > 0 and (hi - lo) / hi <= tol

    @property
    def balanced(self) -> bool:
        return self.is_balanced()


def solve_balanced(
    M: int, K: int, N: int,
    *,
    hw: pm.HardwareSpec | str | None = None,
    in_dtype=torch.bfloat16,
    out_dtype=None,
    b_layout: str = "row",
    vmem_budget: int | None = None,
    measure_fn: Callable[[GemmPlan], float] | None = None,
) -> BalanceResult:
    """§4.5.2: walk bk down from the compute-optimal kernel to the balanced
    point. ``measure_fn(plan) -> seconds`` replaces the model when given;
    the walk stops after three probes in a row that do not improve."""
    hw = resolve_hw(hw)
    if out_dtype is None:
        out_dtype = in_dtype
    ty_in = pm.itemsize(in_dtype)
    ty_out = pm.itemsize(out_dtype)
    budget = vmem_budget or hw.vmem_bytes
    route = _route(hw, M, in_dtype, b_layout)

    def evaluate(plan: GemmPlan) -> BalanceStep:
        est = pm.estimate_gemm(
            hw, M, K, N, plan.bm, plan.bk, plan.bn,
            in_dtype=in_dtype, out_dtype=out_dtype, b_layout=b_layout)
        t_total = measure_fn(plan) if measure_fn is not None else est.t_total
        return BalanceStep(
            plan=plan, t_comp=est.t_comp, t_mem=est.t_mem, t_total=t_total,
            tops=2.0 * M * K * N / t_total / 1e12,
        )

    start = solve_single_core(
        hw=hw, in_dtype=in_dtype, out_dtype=out_dtype, b_layout=b_layout,
        vmem_budget=budget, route=route,
    )
    steps = [evaluate(start.plan)]
    drops = 0
    last_mn = steps[-1].plan.bm * steps[-1].plan.bn
    # the bk candidates below the start, largest first: the reference's
    # bk -= LANE on a TPU, bk -= BK_STEP on a GPU route that tiles K freely
    _, bks, _ = hw.candidate_blocks(ty_in, route)
    for bk in sorted((b for b in bks if b < start.plan.bk), reverse=True):
        if drops >= 3:
            break
        plan = _solve_fixed_bk(
            bk, hw=hw, ty_in=ty_in, ty_out=ty_out, in_dtype=in_dtype,
            b_layout=b_layout, budget=budget, route=route,
        )
        if plan is None:
            continue
        if plan.bm * plan.bn <= last_mn:
            continue  # smaller bk must buy a larger output tile to matter
        last_mn = plan.bm * plan.bn
        step = evaluate(plan)
        best_t = min(s.t_total for s in steps)
        steps.append(step)
        # three consecutive non-improving probes before declaring the knee
        # (the model's tile landscape is bumpier than wall clock)
        drops = drops + 1 if step.t_total > best_t else 0
    best = min(steps, key=lambda s: s.t_total)
    return BalanceResult(plan=best.plan, steps=steps, tops=best.tops)


def kv_bytes_per_token(
    n_kv_heads: int,
    head_dim: int,
    *,
    kv_dtype: KVCacheDtype | str | None = None,
    n_layers: int = 1,
    block_size: int | None = None,
) -> float:
    """Pool bytes one cached token occupies across all layers (K + V, plus
    the amortized per-block scale overhead when the pool is quantized)."""
    kvd = KVCacheDtype.parse(kv_dtype)
    per = 2.0 * n_kv_heads * head_dim * kvd.itemsize * n_layers
    if kvd.quantized:
        if not block_size:
            raise ValueError(
                "quantized KV amortizes per-block scales — pass block_size")
        per += n_layers * kvd.scale_bytes_per_block(n_kv_heads) / block_size
    return per


@dataclasses.dataclass(frozen=True)
class KVTrafficEstimate:
    """Decode-attention memory traffic for one step over one lane's cache."""

    bytes_per_token: float   # pool bytes per cached token (all layers)
    read_bytes: float        # gather traffic: context_tokens * bytes/token
    t_mem: float             # seconds to stream it at HBM bandwidth


def decode_kv_traffic(
    context_tokens: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    hw: pm.HardwareSpec | str | None = None,
    kv_dtype: KVCacheDtype | str | None = None,
    n_layers: int = 1,
    block_size: int | None = None,
) -> KVTrafficEstimate:
    """Memory-side model of a paged decode-attention step: the gather walks
    the lane's whole live KV once a step, so its time is streaming
    bandwidth (Eqs. 6-7's DRAM term applied to the cache). An int8 pool
    moves about half the bytes a token; its dequantize rides the same
    pass."""
    hw = resolve_hw(hw)
    bpt = kv_bytes_per_token(
        n_kv_heads, head_dim, kv_dtype=kv_dtype, n_layers=n_layers,
        block_size=block_size)
    read = context_tokens * bpt
    return KVTrafficEstimate(
        bytes_per_token=bpt, read_bytes=read, t_mem=read / hw.hbm_bw)


def solve_exhaustive(
    M: int, K: int, N: int,
    *,
    hw: pm.HardwareSpec | str | None = None,
    in_dtype=torch.bfloat16,
    out_dtype=None,
    b_layout: str = "row",
) -> BalanceResult:
    """Evaluate the modeled end-to-end time of every feasible tile and keep
    the fastest (ties go to the first in sweep order, as in the reference).
    """
    hw = resolve_hw(hw)
    if out_dtype is None:
        out_dtype = in_dtype
    ty_in = pm.itemsize(in_dtype)
    ty_out = pm.itemsize(out_dtype)
    budget = hw.vmem_bytes
    route = hw.gemm_route(M, in_dtype, b_layout)
    bms, bks, bns = hw.candidate_blocks(ty_in, route)
    best: BalanceStep | None = None
    for bm in bms:
        for bn in bns:
            for bk in bks:
                if hw.working_set(bm, bk, bn, ty_in, ty_out, route) > budget:
                    break  # bk ascending: larger only grows the working set
                est = pm.estimate_gemm(
                    hw, M, K, N, bm, bk, bn, in_dtype=in_dtype,
                    out_dtype=out_dtype, b_layout=b_layout)
                if best is None or est.t_total < best.t_total:
                    best = BalanceStep(
                        plan=GemmPlan(bm=bm, bk=bk, bn=bn),
                        t_comp=est.t_comp, t_mem=est.t_mem,
                        t_total=est.t_total,
                        tops=2.0 * M * K * N / est.t_total / 1e12,
                    )
    if best is None:
        raise ValueError(f"no tile of {hw.name} fits the {budget}-byte "
                         "working-set budget")
    return BalanceResult(plan=best.plan, steps=[best], tops=best.tops)
