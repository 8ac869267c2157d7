"""Measured-feedback tile autotuner (port of ``repro.core.autotune``).

Wraps the §4.5.2 walk with a measurement callback and adds a neighbour
hill-climb (the beyond-paper part): after the walk converges, probe the
one-step neighbourhood of the balanced plan. ``refine_cached_plans`` does
the same for the plans a warm-up put in the plan cache.

What a neighbour is depends on the hardware: under a TPU spec the
reference's steps (a sublane or 128 rows, 128 lanes of K and N); under a
GPU spec the tiles ``csrc/matmul.cu`` is built for on the GEMM's route
(the adjacent (bm, bn) of ``kernels.matmul.TILES[route]``, bk one
``BK_STEP`` either way where the route has no fixed ``TC_BK``).

Measurement: ``model_measure_fn`` is the analytical model;
``wallclock_measure_fn`` times the fat kernel through
``kernels.ops.balanced_matmul``: on a CUDA device the median of
``repeats`` calls timed with CUDA events, each after a read of 256 MiB
that evicts the operands from L2 (the serving path streams its weights
cold); on the CPU the plain version on the host clock (best of
``repeats``), as the reference times interpret mode. A measured function
carries ``launched(plan)``, the plan the wrapper really launches
(``ops._clamp_plan``): refinement measures each launched plan once and
stores the launched plan.
"""
from __future__ import annotations

import dataclasses
import functools
import statistics
import time
from typing import Callable, Iterable

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core import balance, perfmodel as pm
from repro_torch.core.context import resolve_hw
from repro_torch.core.plancache import BalanceSnapshot
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ops
from repro_torch.kernels.ops import GemmPlan

# bytes read before each timed call: five times the H100's 50 MB L2
FLUSH_BYTES = 256 * 2**20


@dataclasses.dataclass
class TuneRecord:
    plan: GemmPlan
    seconds: float
    source: str  # 'paper-iteration' | 'hillclimb'


@dataclasses.dataclass
class TuneResult:
    plan: GemmPlan
    seconds: float
    history: list[TuneRecord]


def model_measure_fn(
    M: int, K: int, N: int, *, hw=None, in_dtype=torch.bfloat16,
    out_dtype=None, b_layout="row",
) -> Callable[[GemmPlan], float]:
    """Analytical-model 'measurement'."""
    hw = resolve_hw(hw)

    def fn(plan: GemmPlan) -> float:
        return pm.estimate_gemm(
            hw, M, K, N, plan.bm, plan.bk, plan.bn, in_dtype=in_dtype,
            out_dtype=out_dtype, b_layout=b_layout,
        ).t_total

    return fn


@functools.cache
def _flush_buffer(device: torch.device) -> torch.Tensor:
    return torch.ones(FLUSH_BYTES, dtype=torch.uint8, device=device)


def gemm_inputs(M: int, K: int, N: int, *, in_dtype, b_layout: str,
                device, seed: int = 0):
    """A (M, K) and B ((K, N) row or (N, K) col) from a seeded generator on
    ``device``: integers drawn from [-100, 100) as the reference draws
    them, floats standard normal. B is what the plan is solved for
    (``kernels.matmul.plan_route``): int8 for an int8 A, f32 (the model's
    weights) for a float A."""
    device = torch.device(device)
    in_dtype = torch_dtype(in_dtype)
    b_dtype = torch.int8 if in_dtype == torch.int8 else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)

    def mk(shape, dtype):
        if not dtype.is_floating_point:
            return torch.randint(-100, 100, shape, generator=gen,
                                 device=device, dtype=dtype)
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    a = mk((M, K), in_dtype)
    b = mk((N, K) if b_layout == "col" else (K, N), b_dtype)
    return a, b


def wallclock_measure_fn(
    M: int, K: int, N: int, *, in_dtype=torch.bfloat16, out_dtype=None,
    b_layout="row", device="cuda", repeats: int = 5, hw=None,
) -> Callable[[GemmPlan], float]:
    """Seconds of one ``balanced_matmul`` call at a plan: on a CUDA device
    the median of ``repeats`` CUDA-event timings, each after reading
    ``FLUSH_BYTES``; on the CPU the best of ``repeats`` host-clock timings
    of the plain version. Each launched plan is timed once (memoized).
    The function's ``launched(plan)`` is the plan the wrapper launches."""
    hw = resolve_hw(hw)
    device = torch.device(device)
    dtype = torch_dtype(in_dtype)
    out_dtype = None if out_dtype is None else torch_dtype(out_dtype)
    a, b = gemm_inputs(M, K, N, in_dtype=dtype, b_layout=b_layout,
                       device=device)
    seconds: dict[GemmPlan, float] = {}

    def launched(plan: GemmPlan) -> GemmPlan:
        return ops._clamp_plan(plan, M, K, N, dtype, hw, b_layout)

    def call(plan):
        return ops.balanced_matmul(a, b, plan=plan, out_dtype=out_dtype,
                                   b_layout=b_layout, hw=hw)

    def time_cuda(plan) -> float:
        flush = _flush_buffer(device)
        call(plan)  # the first launch of a tile sets its attributes
        times = []
        for _ in range(repeats):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(plan)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return statistics.median(times)

    def time_host(plan) -> float:
        call(plan)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            call(plan)
            best = min(best, time.perf_counter() - t0)
        return best

    def fn(plan: GemmPlan) -> float:
        p = launched(plan)
        if p not in seconds:
            seconds[p] = (time_cuda if device.type == "cuda"
                          else time_host)(p)
        return seconds[p]

    fn.launched = launched
    return fn


def _neighbors(plan: GemmPlan, itemsize: int, hw=None,
               route: str | None = None) -> list[GemmPlan]:
    """The one-step neighbourhood of ``plan`` (``plan`` itself excluded):
    the reference's steps under a TPU spec, the route's adjacent built
    tiles under a GPU spec."""
    hw = resolve_hw(hw)
    if hw.kind == "gpu":
        tiles = _mm.TILES[route]
        bms = sorted({bm for bm, _ in tiles})
        bns = sorted({bn for _, bn in tiles})

        def near(options, x):
            i = options.index(x) if x in options else None
            if i is None:
                return []
            return [options[j] for j in (i - 1, i, i + 1)
                    if 0 <= j < len(options)]

        dks = ((0,) if route in _mm.TC_BK
               else (-_mm.BK_STEP, 0, _mm.BK_STEP))
        out = []
        for bm in near(bms, plan.bm):
            for dk in dks:
                for bn in near(bns, plan.bn):
                    bk = plan.bk + dk
                    if (bm, bn) not in tiles or not _mm.valid_bk(route, bk):
                        continue
                    if (bm, bk, bn) != (plan.bm, plan.bk, plan.bn):
                        out.append(GemmPlan(bm=bm, bk=bk, bn=bn))
        return out
    sub = pm.SUBLANE[itemsize]
    out = []
    for dm in (-128, -sub, 0, sub, 128):
        for dk in (-pm.LANE, 0, pm.LANE):
            for dn in (-pm.LANE, 0, pm.LANE):
                bm, bk, bn = plan.bm + dm, plan.bk + dk, plan.bn + dn
                if bm >= sub and bk >= pm.LANE and bn >= pm.LANE:
                    if (bm, bk, bn) != (plan.bm, plan.bk, plan.bn):
                        out.append(GemmPlan(bm=bm, bk=bk, bn=bn))
    return out


def refine_cached_plans(
    cache,
    keys: Iterable[tuple] | None = None,
    *,
    measure_factory: Callable[..., Callable[[GemmPlan], float]] | None = None,
    device="cuda",
    repeats: int = 5,
    rounds: int = 1,
    resolve: bool = False,
) -> dict[str, int]:
    """Refine cached plans in place with measured feedback.

    For each plan-cache key (default: the signatures the most recent
    warm-up consulted, ``cache.warm_keys``), measure the cached plan
    against its one-step tile neighbourhood and keep the measured best.
    ``measure_factory(M, K, N, in_dtype=…, out_dtype=…, b_layout=…)``
    builds the per-signature measurement; the default is
    :func:`wallclock_measure_fn` on ``device``. Keys missing from the cache
    are skipped: refinement never adds signatures. Where the measurement
    carries ``launched`` (the wall clock does), candidates that launch a
    plan already measured are skipped and the launched plan is stored.

    ``resolve=True`` is the balance auditor's re-solve path: each key is
    first re-solved from the model (``solve_exhaustive``, direct: no cache
    counters touched) and the fresh plan competes with the cached one as
    the hill-climb start. Either way the entry's balance snapshot is
    refreshed to the winner's current model evaluation, so a refined
    signature stops reading as drifted. The caller persists with
    ``cache.save()``.
    """
    if measure_factory is None:
        def measure_factory(M, K, N, **kw):
            return wallclock_measure_fn(M, K, N, device=device,
                                        repeats=repeats, **kw)
    keys = list(cache.warm_keys if keys is None else keys)
    stats = {"measured": 0, "refined": 0, "kept": 0, "skipped": 0}
    for key in keys:
        plan = cache.entries.get(key)
        if plan is None:
            stats["skipped"] += 1
            continue
        _hw, M, K, N, in_dtype, out_dtype, b_layout = key
        din, dout = torch_dtype(in_dtype), torch_dtype(out_dtype)
        fn = measure_factory(M, K, N, in_dtype=din, out_dtype=dout,
                             b_layout=b_layout)
        # a measurement that knows the launched plan dedupes on it (the
        # model's, like the reference, measures every candidate)
        canon = getattr(fn, "launched", None)
        seen: set | None = None if canon is None else {canon(plan)}

        def fresh_launch(cand: GemmPlan) -> bool:
            if seen is None:
                return True
            if canon(cand) in seen:
                return False
            seen.add(canon(cand))
            return True

        ty, ty_out = pm.itemsize(din), pm.itemsize(dout)
        hw = resolve_hw(_hw)
        route = hw.gemm_route(M, din, b_layout)
        best_plan, best_t = plan, fn(plan)
        stats["measured"] += 1
        if resolve:
            fresh = balance.solve_exhaustive(
                M, K, N, hw=hw, in_dtype=din, out_dtype=dout,
                b_layout=b_layout).plan
            if fresh != plan and fresh_launch(fresh):
                t = fn(fresh)
                stats["measured"] += 1
                if t < best_t:
                    best_plan, best_t = fresh, t
        for _ in range(max(1, rounds)):
            improved = False
            for cand in _neighbors(best_plan, ty, hw, route):
                if hw.working_set(cand.bm, cand.bk, cand.bn, ty, ty_out,
                                  route) > hw.vmem_bytes:
                    continue
                if not fresh_launch(cand):
                    continue
                t = fn(cand)
                stats["measured"] += 1
                if t < best_t:
                    best_plan, best_t, improved = cand, t, True
            if not improved:
                break
        if best_plan is not plan and canon is not None:
            best_plan = canon(best_plan)
        est = pm.estimate_gemm(
            hw, M, K, N, best_plan.bm, best_plan.bk, best_plan.bn,
            in_dtype=din, out_dtype=dout, b_layout=b_layout)
        cache.update(key, best_plan, balance=BalanceSnapshot(
            t_comp=est.t_comp, t_mem=est.t_mem))
        if best_plan is not plan:
            stats["refined"] += 1
        else:
            stats["kept"] += 1
    return stats


def autotune(
    M: int, K: int, N: int,
    *,
    hw: pm.HardwareSpec | str | None = None,
    in_dtype=torch.bfloat16,
    out_dtype=None,
    b_layout: str = "row",
    measure_fn: Callable[[GemmPlan], float] | None = None,
    hillclimb_rounds: int = 3,
    min_gain: float = 0.05,
) -> TuneResult:
    """Paper walk (§4.5.2) + neighbour hill-climb. Stops after
    ``hillclimb_rounds`` consecutive rounds with < ``min_gain`` relative
    improvement."""
    hw = resolve_hw(hw)
    if measure_fn is None:
        measure_fn = model_measure_fn(
            M, K, N, hw=hw, in_dtype=in_dtype, out_dtype=out_dtype,
            b_layout=b_layout)
    ty = pm.itemsize(in_dtype)
    ty_out = pm.itemsize(out_dtype or in_dtype)
    budget = hw.vmem_bytes
    route = hw.gemm_route(M, in_dtype, b_layout)

    res = balance.solve_balanced(
        M, K, N, hw=hw, in_dtype=in_dtype, out_dtype=out_dtype,
        b_layout=b_layout, measure_fn=measure_fn,
    )
    history = [
        TuneRecord(plan=s.plan, seconds=s.t_total, source="paper-iteration")
        for s in res.steps
    ]
    best_plan = res.plan
    best_t = min(s.t_total for s in res.steps)

    stale = 0
    while stale < hillclimb_rounds:
        round_best_plan, round_best_t = None, best_t
        for cand in _neighbors(best_plan, ty, hw, route):
            if hw.working_set(cand.bm, cand.bk, cand.bn, ty, ty_out,
                              route) > budget:
                continue
            t = measure_fn(cand)
            history.append(TuneRecord(plan=cand, seconds=t, source="hillclimb"))
            if t < round_best_t:
                round_best_plan, round_best_t = cand, t
        if round_best_plan is None or (best_t - round_best_t) / best_t < min_gain:
            stale += 1
            if round_best_plan is not None and round_best_t < best_t:
                best_plan, best_t = round_best_plan, round_best_t
        else:
            stale = 0
            best_plan, best_t = round_best_plan, round_best_t
    return TuneResult(plan=best_plan, seconds=best_t, history=history)
