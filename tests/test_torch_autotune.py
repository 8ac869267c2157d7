"""The port's paper walk, KV-traffic model, tiling descriptor and measured
autotuner (``repro_torch.core.balance`` / ``tiling`` / ``autotune``)
against the reference's, on the CPU.

Under a TPU spec every figure is held to the reference's exactly (the
same formulas on the same floats): ``solve_single_core`` /
``solve_balanced`` plans and steps over a shape grid, the KV-traffic
figures, ``TileConfig``, and ``autotune`` / ``refine_cached_plans`` with
the model as the measure. Under ``h100``: the walk and the neighbours
stay within the tiles ``csrc/matmul.cu`` is built for, ``solve_exhaustive``
is never slower (modeled) than the walk, the tiling's grid is counted in
waves over the SMs, and the CPU wall clock measures each launched plan
once and stores the launched plan.
"""
import itertools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import autotune as RA
from repro.core import balance as RB
from repro.core import gemm as RG
from repro.core.plancache import PlanCache as RPlanCache
from repro.core.tiling import TileConfig as RTile
from repro.kernels.ops import GemmPlan as RPlan
from repro_torch.core import autotune as TA
from repro_torch.core import balance as TB
from repro_torch.core import gemm as TG
from repro_torch.core import perfmodel as tpm
from repro_torch.core.hwregistry import get_hw
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.core.tiling import TileConfig as TTile
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels.ops import GemmPlan as TPlan

TPUS = ["tpu_v4", "tpu_v5e", "tpu_v6e"]
DTYPES = ["bfloat16", "float32", "int8"]
SHAPES = [(4, 2560, 6912), (8, 6912, 2560), (512, 2560, 2560),
          (2048, 4096, 4096), (40, 2560, 151936)]


def _steps(res):
    return [(s.plan.bm, s.plan.bk, s.plan.bn, s.t_comp, s.t_mem, s.t_total,
             s.tops) for s in res.steps]


def _plan(p):
    return (p.bm, p.bk, p.bn)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", TPUS)
def test_solve_single_core_matches_reference(hw, dtype, layout):
    r = RB.solve_single_core(hw=hw, in_dtype=jnp.dtype(dtype),
                             b_layout=layout)
    t = TB.solve_single_core(hw=hw, in_dtype=getattr(torch, dtype),
                             b_layout=layout)
    assert (_plan(t.plan), t.eff, t.macs, t.vmem, t.compute_bound) == \
        (_plan(r.plan), r.eff, r.macs, r.vmem, r.compute_bound)
    # a small budget (no compute-bound tile fits): the max-MACs fallback
    r = RB.solve_single_core(hw=hw, in_dtype=jnp.dtype(dtype),
                             vmem_budget=2**18)
    t = TB.solve_single_core(hw=hw, in_dtype=getattr(torch, dtype),
                             vmem_budget=2**18)
    assert (_plan(t.plan), t.vmem, t.compute_bound) == \
        (_plan(r.plan), r.vmem, r.compute_bound)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", ["tpu_v5e", "tpu_v6e"])
def test_solve_balanced_matches_reference(hw, dtype, shape):
    M, K, N = shape
    r = RB.solve_balanced(M, K, N, hw=hw, in_dtype=jnp.dtype(dtype))
    t = TB.solve_balanced(M, K, N, hw=hw, in_dtype=getattr(torch, dtype))
    assert _steps(t) == _steps(r)
    assert _plan(t.plan) == _plan(r.plan) and t.tops == r.tops
    assert t.balanced == r.balanced
    assert [t.is_balanced(tol) for tol in (0.05, 0.5)] == \
        [r.is_balanced(tol) for tol in (0.05, 0.5)]


def test_solve_balanced_with_a_measure_matches_reference():
    """The walk with a measurement in the model's place (the model times a
    deterministic tile-dependent factor) stops where the reference's
    stops."""
    from repro.core import perfmodel as rpm
    from repro_torch.core import perfmodel as tpm

    M, K, N = 512, 2560, 2560
    factor = lambda p: 1 + (p.bk % 384) / 1e3 + (p.bn % 256) / 1e4
    rhw, thw = rpm.TPU_V5E, get_hw("tpu_v5e")
    r = RB.solve_balanced(M, K, N, hw="tpu_v5e", measure_fn=lambda p:
                          rpm.estimate_gemm(rhw, M, K, N, p.bm, p.bk,
                                            p.bn).t_total * factor(p))
    t = TB.solve_balanced(M, K, N, hw="tpu_v5e", measure_fn=lambda p:
                          tpm.estimate_gemm(thw, M, K, N, p.bm, p.bk,
                                            p.bn).t_total * factor(p))
    assert _steps(t) == _steps(r) and _plan(t.plan) == _plan(r.plan)


@pytest.mark.parametrize("kv", [None, "bf16", "int8"])
@pytest.mark.parametrize("dims", [(20, 128, 40, 16), (4, 64, 2, 4),
                                  (8, 128, 32, 32)])
def test_kv_traffic_matches_reference(dims, kv):
    heads, hd, layers, block = dims
    kw = dict(kv_dtype=kv, n_layers=layers, block_size=block)
    assert TB.kv_bytes_per_token(heads, hd, **kw) == \
        RB.kv_bytes_per_token(heads, hd, **kw)
    for ctx in (1, 128, 4096):
        for hw in TPUS:
            r = RB.decode_kv_traffic(ctx, heads, hd, hw=hw, **kw)
            t = TB.decode_kv_traffic(ctx, heads, hd, hw=hw, **kw)
            assert (t.bytes_per_token, t.read_bytes, t.t_mem) == \
                (r.bytes_per_token, r.read_bytes, r.t_mem)
    if kv == "int8":
        with pytest.raises(ValueError):
            TB.kv_bytes_per_token(heads, hd, kv_dtype="int8")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh", [(1, 1), (2, 4)])
def test_tile_config_matches_reference(dtype, mesh):
    for (M, K, N), plan in itertools.product(
            SHAPES, [(128, 512, 128), (32, 1024, 256), (1024, 2560, 1408)]):
        r = RTile(M, K, N, RPlan(*plan), in_dtype=dtype, out_dtype=dtype,
                  m_rows=mesh[0], n_cols=mesh[1])
        t = TTile(M, K, N, TPlan(*plan), in_dtype=dtype, out_dtype=dtype,
                  m_rows=mesh[0], n_cols=mesh[1])
        assert (t.intrinsic, t.block, t.vmem_working_set(), t.native_size,
                t.padded, t.grid, t.padding_waste) == \
            (r.intrinsic, r.block, r.vmem_working_set(), r.native_size,
             r.padded, r.grid, r.padding_waste)
        assert t.waves == 1
        try:
            r.validate()
        except ValueError:
            with pytest.raises(ValueError):
                t.validate()
        else:
            t.validate()


@pytest.mark.parametrize("shape", [(512, 2560, 2560), (4, 2560, 6912),
                                   (8, 512, 1024)])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_autotune_with_the_model_matches_reference(shape, dtype):
    M, K, N = shape
    r = RA.autotune(M, K, N, hw="tpu_v5e", in_dtype=jnp.dtype(dtype))
    t = TA.autotune(M, K, N, hw="tpu_v5e", in_dtype=getattr(torch, dtype))
    assert [(_plan(h.plan), h.seconds, h.source) for h in t.history] == \
        [(_plan(h.plan), h.seconds, h.source) for h in r.history]
    assert _plan(t.plan) == _plan(r.plan) and t.seconds == r.seconds


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("resolve", [False, True])
def test_refine_cached_plans_with_the_model_matches_reference(resolve,
                                                              rounds):
    rc, tc = RPlanCache(), TPlanCache()
    shapes = [(512, 2560, 2560, "bfloat16"), (8, 2560, 6912, "int8"),
              (16, 256, 512, "float32"), (128, 1024, 384, "bfloat16")]
    keys = []
    for M, K, N, dt in shapes:
        with rc.warmup():
            RG.plan_for(M, K, N, in_dtype=jnp.dtype(dt), hw="tpu_v5e",
                        cache=rc)
        with tc.warmup():
            TG.plan_for(M, K, N, in_dtype=getattr(torch, dt), hw="tpu_v5e",
                        cache=tc)
        keys.append(("tpu_v5e", M, K, N, dt, dt, "row"))
    for i, k in enumerate(keys[:2]):  # two perturbed entries
        p = rc.entries[k]
        rc.entries[k] = RPlan(p.bm, p.bk + 128 * (i + 1), p.bn)
        tc.entries[k] = TPlan(p.bm, p.bk + 128 * (i + 1), p.bn)
    missing = ("tpu_v5e", 3, 64, 64, "float32", "float32", "row")
    rs = RA.refine_cached_plans(
        rc, keys + [missing], resolve=resolve, rounds=rounds,
        measure_factory=lambda M, K, N, **kw: RA.model_measure_fn(
            M, K, N, hw="tpu_v5e", **kw))
    ts = TA.refine_cached_plans(
        tc, keys + [missing], resolve=resolve, rounds=rounds,
        measure_factory=lambda M, K, N, **kw: TA.model_measure_fn(
            M, K, N, hw="tpu_v5e", **kw))
    assert ts == rs and ts["skipped"] == 1
    assert {k: _plan(p) for k, p in tc.entries.items()} == \
        {k: _plan(p) for k, p in rc.entries.items()}
    assert {k: (s.t_comp, s.t_mem) for k, s in tc.balance.items()} == \
        {k: (s.t_comp, s.t_mem) for k, s in rc.balance.items()}
    assert (tc.stats.warm_solves, tc.stats.lazy_solves) == (4, 0)


# ---------------------------------------------------------------- h100
H100_SHAPES = [(4, 2560, 2560), (8, 2560, 6912), (40, 6912, 2560),
               (128, 2560, 6912), (512, 2560, 2560), (8, 2560, 151936)]


def _built(route, plan) -> bool:
    return ((plan.bm, plan.bn) in mm.TILES[route]
            and mm.valid_bk(route, plan.bk))


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", H100_SHAPES)
def test_h100_walk_stays_on_built_tiles_and_never_beats_the_sweep(
        shape, dtype, layout):
    M, K, N = shape
    hw = get_hw("h100")
    dt = getattr(torch, dtype)
    route = hw.gemm_route(M, dt, layout)
    walk = TB.solve_balanced(M, K, N, hw=hw, in_dtype=dt, b_layout=layout)
    sweep = TB.solve_exhaustive(M, K, N, hw=hw, in_dtype=dt,
                                b_layout=layout)
    assert all(_built(route, s.plan) for s in walk.steps)
    assert _built(route, sweep.plan)
    assert sweep.chosen_step.t_total <= walk.chosen_step.t_total
    for s in walk.steps:
        assert mm.smem_bytes(route, *_plan(s.plan)) <= hw.vmem_bytes
    single = TB.solve_single_core(hw=hw, in_dtype=dt, b_layout=layout,
                                  route=route)
    assert _built(route, single.plan)
    for cand in TA._neighbors(walk.plan, dt.itemsize, hw, route):
        assert _built(route, cand) and cand != walk.plan


@pytest.mark.parametrize("route", sorted(mm.TILES))
def test_h100_neighbors_are_adjacent_built_tiles(route):
    hw = get_hw("h100")
    bms = sorted({bm for bm, _ in mm.TILES[route]})
    bns = sorted({bn for _, bn in mm.TILES[route]})
    for bm, bn in mm.TILES[route]:
        bk = mm.TC_BK.get(route, 256)
        plan = TPlan(bm, bk, bn)
        nbrs = TA._neighbors(plan, 2, hw, route)
        assert len(set(nbrs)) == len(nbrs) and plan not in nbrs
        for c in nbrs:
            assert _built(route, c)
            assert abs(bms.index(c.bm) - bms.index(bm)) <= 1
            assert abs(bns.index(c.bn) - bns.index(bn)) <= 1
            assert abs(c.bk - bk) in ((0,) if route in mm.TC_BK
                                      else (0, mm.BK_STEP))
        if route not in mm.TC_BK:
            assert TPlan(bm, bk + mm.BK_STEP, bn) in nbrs
            assert TPlan(bm, bk - mm.BK_STEP, bn) in nbrs
    # a tile the route is not built for has no neighbours on it
    assert TA._neighbors(TPlan(48, 64, 96), 2, hw, route) == []


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", H100_SHAPES)
def test_h100_tile_config_counts_waves_over_the_sms(shape, dtype):
    M, K, N = shape
    hw = get_hw("h100")
    dt = getattr(torch, dtype)
    plan = TB.solve_exhaustive(M, K, N, hw=hw, in_dtype=dt).plan
    t = TTile(M, K, N, plan, in_dtype=dtype, out_dtype=dtype, hw="h100")
    route = hw.gemm_route(M, dt, "row")
    assert t.route == route
    t.validate()
    assert t.vmem_working_set() == mm.smem_bytes(route, *_plan(plan))
    i, j, k = t.grid
    if route == mm.SPLIT_K:
        splits, _ = mm.split_k(M, K, N, plan.bk, plan.bn, hw.sm_count)
        assert (i, j, k) == (-(-M // mm.rows_per_group(M)),
                             -(-N // plan.bn), splits)
    else:
        assert (i, j, k) == (-(-M // plan.bm), -(-N // plan.bn), 1)
    assert t.waves == -(-(i * j * k) // hw.sm_count)
    # the model's wave quantization reads the same grid
    assert i * j * k / (t.waves * hw.sm_count) == pytest.approx(
        tpm.grid_utilization(hw, M, N, plan.bm, plan.bn, route=route, K=K,
                             bk=plan.bk), rel=1e-12)


def test_gemm_inputs_are_seeded_and_integers_in_range():
    a, b = TA.gemm_inputs(8, 64, 32, in_dtype=torch.int8, b_layout="col",
                          device="cpu")
    a2, b2 = TA.gemm_inputs(8, 64, 32, in_dtype=torch.int8,
                            b_layout="col", device="cpu")
    assert torch.equal(a, a2) and torch.equal(b, b2)
    assert a.shape == (8, 64) and b.shape == (32, 64)
    assert b.dtype == torch.int8
    for t in (a, b):
        assert int(t.min()) >= -100 and int(t.max()) < 100
    a, b = TA.gemm_inputs(4, 32, 16, in_dtype=torch.bfloat16,
                          b_layout="row", device="cpu")
    assert (a.dtype, b.dtype, b.shape) == (torch.bfloat16, torch.float32,
                                           (32, 16))


def test_wallclock_refinement_on_the_cpu_dedupes_launched_plans():
    """The CPU wall clock (the plain version on the host clock) measures
    each launched plan once; refinement stores launched plans, adds no
    signature and touches no solver counter."""
    hw = get_hw("h100")
    cache = TPlanCache()
    shapes = [(8, 256, 512, "bfloat16", "row"), (40, 256, 512, "bfloat16",
                                                  "row"),
              (8, 256, 512, "int8", "col"), (40, 96, 64, "float32", "row")]
    with cache.warmup():
        for M, K, N, dt, lay in shapes:
            TG.plan_for(M, K, N, in_dtype=getattr(torch, dt), hw=hw,
                        b_layout=lay, cache=cache)
    before = cache.stats.snapshot()
    keys = sorted(cache.entries)
    calls = []

    def factory(M, K, N, **kw):
        fn = TA.wallclock_measure_fn(M, K, N, device="cpu", repeats=1,
                                     hw=hw, **kw)

        def measured(plan):
            calls.append((M, K, N, kw["in_dtype"], kw["b_layout"],
                          fn.launched(plan)))
            return fn(plan)
        measured.launched = fn.launched
        return measured

    stats = TA.refine_cached_plans(cache, measure_factory=factory)
    assert stats["measured"] == len(calls)
    assert len(set(calls)) == len(calls)  # each launched plan once
    assert stats["refined"] + stats["kept"] == len(keys)
    assert sorted(cache.entries) == keys
    for key, plan in cache.entries.items():
        _, M, K, N, din, _, lay = key
        dt = getattr(torch, din)
        assert ops._clamp_plan(plan, M, K, N, dt, hw, lay) == plan
        assert _built(hw.gemm_route(M, dt, lay), plan)
    after = cache.stats.snapshot()
    assert (after.hits, after.misses, after.warm_solves,
            after.lazy_solves) == (before.hits, before.misses,
                                   before.warm_solves, before.lazy_solves)


def test_launcher_refines_with_the_callers_measure_factory():
    """``serve.main(measure_factory=)`` hands --measure-plans' timing to
    its caller: every warm signature is measured through it, once per
    candidate (the model carries no ``launched``, so nothing is deduped),
    and the engine then serves on the refined plans with zero lazy
    solves."""
    from repro_torch.launch import serve

    seen = []

    def factory(M, K, N, **kw):
        fn = TA.model_measure_fn(M, K, N, **kw)

        def measured(plan):
            seen.append((M, K, N, plan))
            return fn(plan)
        return measured

    res = serve.main(["--smoke", "--engine", "--kv-block-size", "4",
                      "--device", "cpu", "--plan-cache", "",
                      "--measure-plans"], measure_factory=factory)
    stats = res["measured"]["stats"]
    warm = res["context"].plan_cache.warm_keys
    assert stats["measured"] == len(seen) > 0
    assert {s[:3] for s in seen} == {key[1:4] for key in warm}
    assert stats["refined"] + stats["kept"] == len(warm)
    assert res["lazy_solves"] == 0 and res["misses"] == 0
