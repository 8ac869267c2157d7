"""The port's GEMM layer against the reference, on the CPU.

* ``ops.balanced_matmul`` / ``ops.decode_matvec`` (their plain versions on
  CPU tensors, behind the padding path) against ``repro.kernels.ops`` with
  ``backend="interpret"`` (the Pallas kernel bodies run on the CPU);
* the exhaustive solver, ``plan_for``, ``_clamp_plan`` and the dispatch rule
  under the TPU specs against the reference, plan for plan;
* the plan-cache file format across the two packages;
* the ``h100`` plans: inside the CUDA kernel's tile set and its shared
  memory, and the wrappers' device handling (meta, CPU, split-K).

Tolerances: both sides accumulate in f32 (i32 for int8) from the same
inputs in another summation order. An f32 output may differ by a few f32
ulps of the largest partial sum (rtol 1e-5, atol 1e-5 * max|C|); a bf16
output may round to the neighbouring value, one bf16 ulp = 2**-7 of the
largest magnitude; i32 outputs are exact; a requantized int8 output may flip
one rounding tie when the compilers order the scale and bias operations
differently (|diff| <= 1).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import balance as RB
from repro.core import gemm as RG
from repro.core import plancache as RPC
from repro.kernels import ops as RO
from repro_torch.core import balance as TB
from repro_torch.core import gemm as TG
from repro_torch.core import plancache as TPC
from repro_torch.core.context import use_context
from repro_torch.interop import to_tensor
from repro_torch.kernels import decode_matvec as tmv
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as TO

RNG = np.random.default_rng(2024)
JNP = {"bfloat16": jnp.bfloat16, "float32": jnp.float32, "int8": jnp.int8,
       "int16": jnp.int16, "int32": jnp.int32}


def _pair(shape, dtype: str, scale: float = 1.0):
    """The same values as a jax array and a torch CPU tensor."""
    if dtype == "int8":
        x = RNG.integers(-100, 100, size=shape).astype(np.int8)
    else:
        x = (RNG.normal(size=shape) * scale).astype(np.float32)
    j = jnp.asarray(x, JNP[dtype])
    return j, to_tensor(np.asarray(j), "cpu")


def _assert_close(got: torch.Tensor, want, out_dtype: str):
    want = np.asarray(want).astype(np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    peak = max(1.0, float(np.abs(want).max(initial=0.0)))
    if out_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * peak)
    elif out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * peak)
    elif out_dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max(initial=0) <= 1


SHAPES = [(128, 256, 128), (100, 300, 200), (33, 520, 65), (1, 128, 128)]
TYPE_CASES = [  # (A, B, out)
    ("bfloat16", "bfloat16", "bfloat16"),
    ("bfloat16", "float32", "bfloat16"),
    ("float32", "float32", "float32"),
    ("int8", "int8", "int32"),
]


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("a_dt,b_dt,out_dt", TYPE_CASES)
@pytest.mark.parametrize("layout", ["row", "col"])
def test_balanced_matmul_matches_reference(M, K, N, a_dt, b_dt, out_dt,
                                           layout):
    ja, ta = _pair((M, K), a_dt)
    jb, tb = _pair((N, K) if layout == "col" else (K, N), b_dt, K ** -0.5)
    want = RO.balanced_matmul(ja, jb, plan=RO.GemmPlan(64, 128, 128),
                              out_dtype=JNP[out_dt], b_layout=layout,
                              backend="interpret")
    got = TO.balanced_matmul(ta, tb, plan=TO.GemmPlan(64, 128, 128),
                             out_dtype=getattr(torch, out_dt),
                             b_layout=layout, hw="h100")
    assert got.dtype == getattr(torch, out_dt)
    _assert_close(got, want, out_dt)


@pytest.mark.parametrize("activation", ["relu", "relu2", "gelu", "silu"])
@pytest.mark.parametrize("hw", ["h100", "tpu_v5e"])
def test_fused_epilogue_bf16_x_f32_matches_reference(activation, hw):
    """The main path's mixed product: bf16 activation, f32 weight, f32
    bias, every activation; the weight is never rounded to bf16."""
    ja, ta = _pair((96, 300), "bfloat16")
    jb, tb = _pair((300, 200), "float32", 300 ** -0.5)
    jbias, tbias = _pair((200,), "float32")
    want = RO.balanced_matmul(ja, jb, jbias, plan=RO.GemmPlan(32, 128, 128),
                              out_dtype=jnp.float32, activation=activation,
                              backend="interpret")
    got = TO.balanced_matmul(ta, tb, tbias, plan=TO.GemmPlan(32, 128, 128),
                             out_dtype=torch.float32, activation=activation,
                             hw=hw)
    _assert_close(got, want, "float32")


@pytest.mark.parametrize("out_dt", ["int8", "int16", "int32", "float32"])
def test_int8_requant_epilogue_matches_reference(out_dt):
    """int8 x int8 -> i32, requant by a per-channel scale, f32 bias after
    it, rint half-to-even, saturating cast."""
    ja, ta = _pair((70, 384), "int8")
    jb, tb = _pair((130, 384), "int8")
    scale = (RNG.random(130) * 2e-4).astype(np.float32)
    jbias, tbias = _pair((130,), "float32")
    want = RO.balanced_matmul(ja, jb, jbias, plan=RO.GemmPlan(32, 128, 128),
                              out_dtype=JNP[out_dt], b_layout="col",
                              activation="relu", out_scale=jnp.asarray(scale),
                              backend="interpret")
    got = TO.balanced_matmul(ta, tb, tbias, plan=TO.GemmPlan(32, 128, 128),
                             out_dtype=getattr(torch, out_dt), b_layout="col",
                             activation="relu",
                             out_scale=torch.from_numpy(scale), hw="h100")
    tol_dt = "int8" if out_dt != "float32" else out_dt
    _assert_close(got, want, tol_dt)


def test_int8_saturation_matches_reference():
    ja = jnp.full((32, 512), 100, jnp.int8)
    jb = jnp.full((512, 128), 100, jnp.int8)
    for od in ("int8", "int16"):
        want = RO.balanced_matmul(ja, jb, plan=RO.GemmPlan(32, 128, 128),
                                  out_dtype=JNP[od], backend="interpret")
        got = TO.balanced_matmul(to_tensor(np.asarray(ja), "cpu"),
                                 to_tensor(np.asarray(jb), "cpu"),
                                 out_dtype=getattr(torch, od))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.max()) == np.iinfo(od).max


@pytest.mark.parametrize("B", [1, 4, 17])
@pytest.mark.parametrize("x_dt,w_dt,out_dt", [
    ("bfloat16", "float32", "float32"), ("bfloat16", "float32", "bfloat16"),
    ("int8", "int8", "int32")])
@pytest.mark.parametrize("layout", ["row", "col"])
def test_decode_matvec_matches_reference(B, x_dt, w_dt, out_dt, layout):
    K, N = 700, 300  # ragged against every block
    jx, tx = _pair((B, K), x_dt)
    jw, tw = _pair((N, K) if layout == "col" else (K, N), w_dt, K ** -0.5)
    want = RO.decode_matvec(jx, jw, bk=256, bn=128, out_dtype=JNP[out_dt],
                            w_layout=layout, backend="interpret")
    got = TO.decode_matvec(tx, tw, bk=256, bn=128,
                           out_dtype=getattr(torch, out_dt), w_layout=layout,
                           hw="h100")
    _assert_close(got, want, out_dt)


# ------------------------------------------------------------ planner
SWEEP = [(512, 2560, 2560), (4, 2560, 151936), (100, 300, 200),
         (2048, 4096, 1024), (1, 128, 128)]


@pytest.mark.parametrize("hw", ["tpu_v5e", "tpu_v6e"])
@pytest.mark.parametrize("dt", ["bfloat16", "float32", "int8"])
def test_solve_exhaustive_matches_reference(hw, dt):
    for M, K, N in SWEEP:
        want = RB.solve_exhaustive(M, K, N, hw=hw, in_dtype=JNP[dt])
        got = TB.solve_exhaustive(M, K, N, hw=hw, in_dtype=getattr(torch, dt))
        assert (got.plan.bm, got.plan.bk, got.plan.bn) == (
            want.plan.bm, want.plan.bk, want.plan.bn), (M, K, N)
        assert got.steps[0].t_comp == pytest.approx(want.steps[0].t_comp,
                                                    rel=1e-12)
        assert got.steps[0].t_mem == pytest.approx(want.steps[0].t_mem,
                                                   rel=1e-12)


@pytest.mark.parametrize("hw", ["tpu_v5e", "tpu_v6e"])
def test_plan_for_and_clamp_match_reference(hw):
    rc, tc = RPC.PlanCache(), TPC.PlanCache()
    for M, K, N in SWEEP:
        want = RG.plan_for(M, K, N, in_dtype=jnp.bfloat16,
                           out_dtype=jnp.float32, hw=hw, cache=rc)
        got = TG.plan_for(M, K, N, in_dtype=torch.bfloat16,
                          out_dtype=torch.float32, hw=hw, cache=tc)
        assert got.__dict__ == want.__dict__
        for m, k, n in [(M, K, N), (3, 70, 5), (M, 100, 1000)]:
            rclamp = RO._clamp_plan(want, m, k, n, jnp.bfloat16)
            tclamp = TO._clamp_plan(got, m, k, n, torch.bfloat16, hw)
            assert tclamp.__dict__ == rclamp.__dict__
    assert set(tc.entries) == set(rc.entries)
    assert tc.stats.warm_solves == rc.stats.warm_solves == 0
    assert tc.stats.lazy_solves == rc.stats.lazy_solves == len(SWEEP)


def test_skinny_dispatch_matches_reference():
    for M in (1, 4, 64, 128, 129, 512):
        for K in (64, 255, 256, 2560):
            for N in (64, 127, 128, 151936):
                assert TG._is_skinny(M, K, N) == RG._is_skinny(M, K, N)


def test_plan_cache_file_loads_in_reference(tmp_path):
    path = str(tmp_path / "plans.json")
    cache = TPC.PlanCache(path=path)
    with use_context(hw="h100", plan_cache=cache):
        for M, K, N in SWEEP:
            TG.plan_for(M, K, N, in_dtype=torch.bfloat16)
    assert cache.save() == path
    ref = RPC.PlanCache(path=path)
    assert ref.load() == len(SWEEP)
    assert {k: (p.bm, p.bk, p.bn) for k, p in ref.entries.items()} == {
        k: (p.bm, p.bk, p.bn) for k, p in cache.entries.items()}
    assert ref.balance == {k: RPC.BalanceSnapshot(s.t_comp, s.t_mem)
                           for k, s in cache.balance.items()}
    again = TPC.PlanCache(path=path)
    assert again.load() == len(SWEEP) and again.entries == cache.entries


# ------------------------------------------------------------ h100
def _slice_signatures():
    """Every GEMM signature of the slice's path, full width: qwen1.5-4b
    served at batch 4, prompt 128, plus the bf16 x bf16 and ragged cases
    chip_smoke.py holds the kernels to."""
    from repro_torch import configs as C

    cache = TPC.PlanCache()
    with use_context(hw="h100", plan_cache=cache):
        TG.plan_model(C.get_config("qwen1.5-4b"), batch=4, prompt_len=128,
                      max_len=145)
        for M, K, N in [(333, 1000, 777), (3, 1000, 777), (128, 256, 128)]:
            TG.plan_for(M, K, N, in_dtype=torch.bfloat16)
        TG.plan_for(512, 2560, 2560, in_dtype=torch.int8,
                    out_dtype=torch.int8)
    return cache


def test_h100_plans_fit_the_cuda_kernels():
    cache = _slice_signatures()
    assert len(cache.entries) == 11
    for key, p in cache.entries.items():
        _, M, K, N, din, _, layout = key
        r = tmm.plan_route(M, getattr(torch, din), layout)
        assert (p.bm, p.bn) in tmm.TILES[r], key
        assert tmm.valid_bk(r, p.bk), key
        assert tmm.smem_bytes(r, p.bm, p.bk, p.bn) <= 232_448, key
        c = TO._clamp_plan(p, M, K, N, getattr(torch, din), "h100", layout)
        assert (c.bm, c.bn) in tmm.TILES[r] and tmm.valid_bk(r, c.bk), key
        if TG._is_skinny(M, K, N):  # the GEMV kernel takes the same blocks
            for w_dt in (torch.float32, torch.bfloat16, torch.int8):
                lanes = p.bn // tmv.vec_elems(w_dt)
                assert p.bn % tmv.vec_elems(w_dt) == 0
                assert lanes and tmv.THREADS % lanes == 0


def test_h100_clamp_stays_in_the_tile_set():
    for plan in (TO.GemmPlan(128, 512, 128), TO.GemmPlan(512, 2048, 1024),
                 TO.GemmPlan(8, 100, 32)):
        for M, K, N in [(1, 1, 1), (5, 33, 70), (700, 5000, 300)]:
            for dt, layout in [(torch.bfloat16, "row"), (torch.int8, "col"),
                               (torch.int8, "row"), (torch.float32, "row")]:
                c = TO._clamp_plan(plan, M, K, N, dt, "h100", layout)
                r = tmm.plan_route(M, dt, layout)
                assert (c.bm, c.bn) in tmm.TILES[r]
                assert tmm.valid_bk(r, c.bk)
                if r in tmm.TC_BK:  # one pipeline stage: fixed by the kernel
                    assert c.bk == tmm.TC_BK[r]
                else:
                    assert 0 < c.bk <= max(plan.bk, tmm.BK_STEP)


@pytest.mark.parametrize("B,K,N,bk,bn", [
    (4, 2560, 2560, 640, 64), (4, 2560, 151936, 320, 128),
    (4, 6912, 2560, 576, 64), (128, 100, 3000, 32, 128), (1, 33, 64, 64, 64)])
def test_split_k_covers_k(B, K, N, bk, bn):
    splits, k_per = tmv.split_k(B, K, N, bk, bn, sm_count=132)
    assert k_per % bk == 0 and splits >= 1
    assert (splits - 1) * k_per < K <= splits * k_per
    blocks = -(-N // bn) * -(-B // tmv.rows_per_group(B))
    assert splits == 1 or blocks * (splits - 1) < tmv.BLOCKS_PER_SM * 132


def test_wrappers_on_meta_and_cpu_launch_nothing():
    before = (tmm.launches, tmv.launches)
    a = torch.empty((5, 300), dtype=torch.bfloat16, device="meta")
    w = torch.empty((300, 70), dtype=torch.float32, device="meta")
    out = tmm.matmul(a, w, bm=16, bk=64, bn=64)
    assert out.device.type == "meta" and out.shape == (5, 70)
    assert out.dtype == torch.bfloat16
    out = tmv.decode_matvec(a, w, bk=64, bn=64, out_dtype=torch.float32)
    assert out.device.type == "meta" and out.dtype == torch.float32
    x = torch.randn(5, 300)
    wc = torch.randn(300, 70)
    torch.testing.assert_close(tmv.decode_matvec(x, wc, bk=64, bn=64),
                               x @ wc, rtol=1e-5, atol=1e-5)
    assert (tmm.launches, tmv.launches) == before


def test_balanced_gemm_routes_by_dispatch_rule(monkeypatch):
    """Decode-shaped with no epilogue -> GEMV kernel; bias or activation
    -> fat kernel (the main path's q/k/v and gate at decode)."""
    calls = []

    def stub(name):
        def fn(a2, b, *args, **kw):
            calls.append(name)
            return torch.empty((a2.shape[0], b.shape[1]), device="meta")
        return fn

    monkeypatch.setattr(TO, "decode_matvec", stub("gemv"))
    monkeypatch.setattr(TO, "balanced_matmul", stub("matmul"))
    x = torch.empty((4, 1, 2560), dtype=torch.bfloat16, device="meta")
    w = torch.empty((2560, 2560), device="meta")
    bias = torch.empty((2560,), device="meta")
    with use_context(hw="h100", plan_cache=TPC.PlanCache()):
        for kw in ({}, {"bias": bias}, {"activation": "silu"}):
            assert TG.balanced_gemm(x, w, **kw).shape == (4, 1, 2560)
        TG.balanced_gemm(torch.empty((512, 2560), device="meta"), w)
    assert calls == ["gemv", "matmul", "matmul", "matmul"]
