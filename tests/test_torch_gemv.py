"""The GEMV kernel's Python side (``repro_torch.kernels.decode_matvec``), on
the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` phase 3a
holds it against its plain version); what surrounds it is checked here:

* the partition: the K splits cover K once, in order, in whole 32-element
  steps of the planner's bk, fill at least one wave of 132 SMs, and a
  block's x slice fits beside the W ring in the shared memory of two blocks
  an SM, for every plan the ``h100`` planner returns on the path shapes;
* the consumer threads' shares (rows and columns a thread holds, tensor-core
  row tiles) and the ring's stages;
* the route rule (TMA needs a 16-byte base and row stride);
* ``ref.gemv_split_ref``, the kernel's summation order (one partial a K
  split, added in split order), against the JAX package's ``decode_matvec``
  run through its Pallas kernel in interpret mode;
* the wrapper's argument checks.

Tolerances: both sides accumulate in f32 (i32 for int8) from the same
inputs in another summation order. An f32 output may differ by a few f32
ulps of the largest partial sum (atol 1e-5 * max|C|); a bf16 output may
round to the neighbouring value, one bf16 ulp = 2**-7 of the largest
magnitude; integer outputs are exact.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as RO
from repro_torch.core import gemm as TG
from repro_torch.core import plancache as TPC
from repro_torch.core.context import use_context
from repro_torch.interop import to_tensor
from repro_torch.kernels import decode_matvec as tmv
from repro_torch.kernels import ref

SM_COUNT = 132
SMEM_OPTIN = 232_448  # shared memory a block may use on an H100
SM_SMEM = 233_472     # shared memory of an SM
ROWS = (1, 4, 8, 9, 16, 32, 33, 64, 128)
PATH_SHAPES = ((2560, 2560), (2560, 6912), (6912, 2560), (8960, 2560),
               (2560, 160), (2560, 65536), (2560, 151936))
DTYPES = ((torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.int8, torch.int8))
JNP = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
       torch.int8: jnp.int8, torch.int16: jnp.int16, torch.int32: jnp.int32}


def _plans():
    """(M, K, N, layout, x dtype, W dtype, bk, bn) of every plan the h100
    planner returns on the path shapes; bk clamped as ``ops.decode_matvec``
    clamps it on the card."""
    out = []
    with use_context(hw="h100", plan_cache=TPC.PlanCache()):
        for M in ROWS:
            for K, N in PATH_SHAPES:
                for layout in ("row", "col"):
                    for x_dt, w_dt in DTYPES:
                        p = TG.plan_for(M, K, N, in_dtype=x_dt,
                                        b_layout=layout)
                        bk = min(p.bk, -(-K // tmv.BK_STEP) * tmv.BK_STEP)
                        out.append((M, K, N, layout, x_dt, w_dt, bk, p.bn))
    return out


PLANS = _plans()


def _launch(M, K, N, layout, x_dt, w_dt, bk, bn, route=tmv.TMA):
    return tmv.launch_plan(M, K, N, bk, bn, x_dt, w_dt, layout, route,
                           SM_COUNT, SMEM_OPTIN)


@pytest.mark.parametrize("route", [tmv.TMA, tmv.CUDA_CORE])
@pytest.mark.parametrize("M", ROWS)
def test_partition_covers_k_once_in_order(M, route):
    for m, K, N, layout, x_dt, w_dt, bk, bn in PLANS:
        if m != M:
            continue
        lp = _launch(M, K, N, layout, x_dt, w_dt, bk, bn, route)
        kps, splits = lp.k_per_split, lp.splits
        # whole steps: a multiple of 32 that divides bk, or bk itself
        assert kps % tmv.BK_STEP == 0 and any(
            kps % g == 0 for g in range(bk, 0, -tmv.BK_STEP) if bk % g == 0)
        # once, in order: splits - 1 whole splits fall short of K
        assert (splits - 1) * kps < K <= splits * kps
        bounds = [min(K, s * kps) for s in range(splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == K
        assert all(a < b for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("M", ROWS)
def test_partition_fills_a_wave_of_132_sms(M):
    for m, K, N, layout, x_dt, w_dt, bk, bn in PLANS:
        if m != M:
            continue
        for route in (tmv.TMA, tmv.CUDA_CORE):
            lp = _launch(M, K, N, layout, x_dt, w_dt, bk, bn, route)
            groups = 1 if route == tmv.TMA else -(-M // tmv.rows_per_group(M))
            blocks = -(-N // bn) * groups * lp.splits
            assert blocks >= SM_COUNT, (M, K, N, layout, x_dt, bk, bn, lp)


@pytest.mark.parametrize("M", ROWS)
def test_x_slice_and_ring_fit_two_blocks_an_sm(M):
    per_block = SM_SMEM // 2 - 1024  # the card keeps 1 KB a block
    for m, K, N, layout, x_dt, w_dt, bk, bn in PLANS:
        if m != M:
            continue
        lp = _launch(M, K, N, layout, x_dt, w_dt, bk, bn)
        x_rows = 16 * lp.mt if lp.mt else -(-M // lp.rt) * lp.rt
        kx = -(-lp.k_per_split // lp.stage_k) * lp.stage_k
        x_bytes = x_rows * (-(-kx * x_dt.itemsize // 16) * 16 + 16)
        need = 1024 + tmv.RING_BYTES + x_bytes + 16 * lp.stages
        assert lp.smem == need
        assert need <= per_block <= SMEM_OPTIN, (M, K, N, layout, lp)
        # the k-lane reduction reuses the drained ring
        assert x_rows * bn * 4 <= tmv.RING_BYTES


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("w_dt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("bn", tmv.TMA_BN)
def test_ring_stages_and_thread_shares(layout, w_dt, bn):
    x_dt = torch.int8 if w_dt == torch.int8 else torch.bfloat16
    for B in range(1, tmv.MAX_ROWS + 1):
        lp = tmv.launch_plan(B, 2560, 2560, 64, bn, x_dt, w_dt, layout,
                             tmv.TMA, SM_COUNT, SMEM_OPTIN)
        stage = (bn * tmv.COL_STAGE_BYTES if layout == "col"
                 else lp.stage_k * bn * w_dt.itemsize)
        assert lp.stages * stage == tmv.RING_BYTES and lp.stages >= 4
        assert stage <= tmv.MAX_STAGE_BYTES and 32 <= lp.stage_k <= 256
        if layout == "row":
            assert lp.k_per_split % lp.stage_k == 0  # only K's end is ragged
        if lp.mt:  # tensor cores: row tiles of 16 cover B
            assert x_dt == torch.bfloat16 and layout == "row"
            assert 16 * lp.mt >= B > 16 * lp.mt // 2 or lp.mt == 1
            continue
        groups = -(-B // lp.rt)
        if layout == "row":
            lanes = bn // tmv.vec_elems(w_dt)
            assert groups * lanes <= tmv.THREADS
            assert lp.rt * tmv.vec_elems(w_dt) <= 64  # accumulators
        else:
            assert bn % lp.cpt == 0
            assert groups * (bn // lp.cpt) <= tmv.THREADS
            assert lp.rt * lp.cpt <= 64


@pytest.mark.parametrize("B,x_dt,layout,want", [
    (9, torch.bfloat16, "row", 1), (16, torch.bfloat16, "row", 1),
    (17, torch.bfloat16, "row", 2), (64, torch.bfloat16, "row", 4),
    (65, torch.bfloat16, "row", 8), (128, torch.bfloat16, "row", 8),
    (8, torch.bfloat16, "row", 0), (1, torch.bfloat16, "row", 0),
    (64, torch.bfloat16, "col", 0), (64, torch.float32, "row", 0),
    (64, torch.int8, "row", 0)])
def test_tensor_core_rows(B, x_dt, layout, want):
    assert tmv.mma_tiles(B, x_dt, layout) == want


def test_route_rule():
    w = torch.zeros(2560, 2560)
    assert tmv.route(w, "row") == tmv.TMA
    assert tmv.route(w, "col") == tmv.TMA
    # row of 777 f32 = 3108 bytes: TMA cannot address it
    assert tmv.route(torch.zeros(1000, 777), "row") == tmv.CUDA_CORE
    assert tmv.route(torch.zeros(777, 1000), "col") == tmv.TMA
    assert tmv.route(torch.zeros(1000, 777, dtype=torch.int8), "col") \
        == tmv.CUDA_CORE
    assert tmv.route(torch.zeros(776, 1008, dtype=torch.bfloat16), "col") \
        == tmv.TMA
    # a base 4 bytes past a 16-byte boundary
    buf = torch.zeros(64 * 64 + 4)
    off = next(i for i in range(4) if (buf.data_ptr() + 4 * i) % 16 == 4)
    w_off = buf[off:off + 64 * 64].view(64, 64)
    assert w_off.data_ptr() % 16 == 4
    assert tmv.route(w_off, "row") == tmv.CUDA_CORE


RNG = np.random.default_rng(14)


def _pair(shape, dtype, scale=1.0):
    if dtype == torch.int8:
        x = RNG.integers(-100, 100, size=shape).astype(np.int8)
    else:
        x = (RNG.normal(size=shape) * scale).astype(np.float32)
    j = jnp.asarray(x, JNP[dtype])
    return j, to_tensor(np.asarray(j), "cpu")


def _assert_close(got, want, out_dtype):
    want = np.asarray(want).astype(np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    peak = max(1.0, float(np.abs(want).max(initial=0.0)))
    if out_dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * peak)
    elif out_dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * peak)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [1, 4, 9, 64, 128])
@pytest.mark.parametrize("x_dt,w_dt,out_dt", [
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32),
    (torch.int8, torch.int8, torch.int32)])
@pytest.mark.parametrize("layout", ["row", "col"])
def test_split_ref_matches_reference(B, x_dt, w_dt, out_dt, layout):
    K, N, bk, bn = 704, 300, 128, 128  # ragged N; several K splits
    jx, tx = _pair((B, K), x_dt)
    jw, tw = _pair((N, K) if layout == "col" else (K, N), w_dt, K ** -0.5)
    lp = tmv.launch_plan(B, K, N, bk, bn, x_dt, w_dt, layout, tmv.TMA,
                         SM_COUNT, SMEM_OPTIN)
    assert lp.splits > 1
    got = ref.gemv_split_ref(tx, tw, splits=lp.splits,
                             k_per_split=lp.k_per_split, out_dtype=out_dt,
                             w_layout=layout)
    want = RO.decode_matvec(jx, jw, bk=256, bn=128, out_dtype=JNP[out_dt],
                            w_layout=layout, backend="interpret")
    _assert_close(got, want, out_dt)
    if out_dt == torch.int32:  # integer sums do not depend on the order
        torch.testing.assert_close(
            got, ref.gemv_ref(tx, tw, out_dtype=out_dt, w_layout=layout),
            rtol=0, atol=0)


def test_split_ref_rejects_a_partition_that_misses_k():
    x, w = torch.zeros(2, 100), torch.zeros(100, 8)
    with pytest.raises(ValueError, match="cover"):
        ref.gemv_split_ref(x, w, splits=3, k_per_split=32)
    with pytest.raises(ValueError, match="cover"):
        ref.gemv_split_ref(x, w, splits=5, k_per_split=32)


def _check_args(x, w, **kw):
    args = dict(B=x.shape[0], K=x.shape[1], N=w.shape[1], bk=64, bn=128,
                out_dtype=torch.bfloat16, r=tmv.TMA)
    args.update(kw)
    tmv._check(x, w, **args)


@pytest.mark.parametrize("case,exc", [
    ("dtype pair", TypeError), ("out dtype", TypeError),
    ("not contiguous", ValueError), ("no rows", ValueError),
    ("too many rows", ValueError), ("bk", ValueError),
    ("tma bn", ValueError), ("core bn", ValueError), ("device", ValueError)])
def test_wrapper_checks_raise(case, exc):
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    w = torch.zeros(256, 512)
    _check_args(x, w)  # the baseline is taken
    bad = {
        "dtype pair": lambda: _check_args(x, w.to(torch.int8)),
        "out dtype": lambda: _check_args(x, w, out_dtype=torch.float16),
        "not contiguous": lambda: _check_args(x, w.t().contiguous().t()),
        "no rows": lambda: _check_args(x[:0], w, B=0),
        "too many rows": lambda: _check_args(
            torch.zeros(129, 256, dtype=torch.bfloat16), w),
        "bk": lambda: _check_args(x, w, bk=48),
        "tma bn": lambda: _check_args(x, w, bn=256),
        "core bn": lambda: _check_args(x, w, bn=24, r=tmv.CUDA_CORE),
        "device": lambda: _check_args(x, w.to("meta")),
    }[case]
    with pytest.raises(exc):
        bad()


def test_wrapper_rejects_bad_layouts_and_devices():
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError, match="w_layout"):
        tmv.decode_matvec(x, torch.zeros(256, 64), bk=64, bn=64,
                          w_layout="diag")
    with pytest.raises(ValueError, match="contraction"):
        tmv.decode_matvec(x, torch.zeros(128, 64), bk=64, bn=64)
    # the CPU runs the plain version and launches nothing
    before = tmv.launches
    out = tmv.decode_matvec(x, torch.ones(256, 64), bk=64, bn=64)
    assert tmv.launches == before and out.shape == (4, 64)
