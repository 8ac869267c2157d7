"""The fat GEMM's routes (``repro_torch.kernels.matmul``), on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds every route
against its plain version there). What surrounds it is plain Python and is
tested here:

* the three-term bf16 split of an f32 B that the tensor-core route
  multiplies (``ref.split_bf16x3``): exact bit for bit (down to 2**-110,
  within bf16's smallest subnormal below), and the three-pass
  product equal to the JAX package's f32 ``matmul_ref`` at the f32
  tolerance (1e-5 of the largest value: both sides are f32 sums of the same
  exact products in another order);
* the route rule: dtypes, B's layout, 16-byte alignment and M -> route;
* the split-K partition: every k once, whole bk steps, partials summed in
  split order;
* the ``h100`` planner against the kernel: tiles, stage depth, shared
  memory and rate of each route.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as RR
from repro_torch.core import hwregistry
from repro_torch.core import perfmodel as pm
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ref

RNG = np.random.default_rng(1313)
H100 = hwregistry.get_hw("h100")


def _adversarial_f32() -> np.ndarray:
    """Full 23-bit significands, every exponent range (largest finite,
    smallest normal, subnormal), halfway and all-ones low halves, signs."""
    f32 = np.finfo(np.float32)
    bits = np.array([0x3F800001, 0x3F807FFF, 0x3F808000, 0x3F80FFFF,
                     0x3FFFFFFF, 0x7F7FFFFF, 0x7F7F8000, 0x00800001,
                     0x00FFFFFF, 0x0000FFFF, 0x00000001, 0x007FFFFF,
                     0x4B7FFFFF, 0x3EAAAAAB], dtype=np.uint32)
    x = np.concatenate([bits.view(np.float32), [f32.max, f32.tiny, 1.0,
                                               -2.0, 0.1, 1 / 3]])
    return np.concatenate([x, -x]).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "wide", "adversarial", "ulps"])
def test_split_bf16x3_is_exact(kind):
    if kind == "normal":
        x = RNG.normal(size=(64, 96)).astype(np.float32) * 0.02
    elif kind == "wide":  # magnitudes 2**-120 .. 2**120
        x = (RNG.normal(size=4096) * np.exp2(
            RNG.uniform(-120, 120, size=4096))).astype(np.float32)
    elif kind == "adversarial":
        x = _adversarial_f32()
    else:  # random bit patterns of finite, nonzero f32
        u = RNG.integers(0, 2**32, size=8192,
                         dtype=np.uint64).astype(np.uint32)
        x = u.view(np.float32)
        x = x[np.isfinite(x) & (x != 0)]
    b = torch.from_numpy(x.copy())
    b1, b2, b3 = ref.split_bf16x3(b)
    assert b1.dtype == b2.dtype == b3.dtype == torch.bfloat16
    total = (b1.float() + b2.float()) + b3.float()
    # exact down to 2**-110; below, the last bits fall under bf16's smallest
    # subnormal (2**-133), which bounds the error
    big = b.abs() >= 2.0**-110
    assert torch.equal(total[big].view(torch.int32), b[big].view(torch.int32))
    assert bool(((total - b)[~big].abs() < 2.0**-133).all())
    # each term holds the next 8 bits of B: B3 is its last bits
    assert bool((b2.float().abs() <= b.abs() * 2.0**-7)[big].all())
    assert bool((b3.float().abs() <= b.abs() * 2.0**-15)[big].all())


def test_split_bf16x3_of_zero_is_zero():
    b = torch.tensor([0.0, -0.0])
    assert all(bool((t.float() == 0).all()) for t in ref.split_bf16x3(b))


@pytest.mark.parametrize("M,K,N,layout", [(96, 300, 200, "row"),
                                          (64, 2560, 32, "row"),
                                          (40, 32, 130, "col")])
def test_three_pass_product_matches_f32_reference(M, K, N, layout):
    """A . B1 + A . B2 + A . B3, each in f32, is the JAX package's full-f32
    product of a bf16 A and an f32 B."""
    a = jnp.asarray(RNG.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    shape = (N, K) if layout == "col" else (K, N)
    b = (RNG.normal(size=shape) * K**-0.5).astype(np.float32)
    want = np.asarray(RR.matmul_ref(a, jnp.asarray(b), out_dtype=jnp.float32,
                                    b_layout=layout), dtype=np.float64)
    ta = torch.from_numpy(np.array(a.astype(jnp.float32)))
    got = torch.zeros((M, N))
    for term in ref.split_bf16x3(torch.from_numpy(b)):
        t = term.float()
        got = got + ta @ (t.t() if layout == "col" else t)
    peak = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5,
                               atol=1e-5 * peak)
    # one bf16 pass is another product: it misses the f32 tolerance
    one = ta @ (ref.split_bf16x3(torch.from_numpy(b))[0].float().t()
                if layout == "col" else
                ref.split_bf16x3(torch.from_numpy(b))[0].float())
    assert np.abs(one.double().numpy() - want).max() > 1e-5 * peak


@pytest.mark.parametrize("M,a,b,layout,aligned,want", [
    (512, torch.bfloat16, torch.float32, "row", True, tmm.TENSOR_CORE),
    (512, torch.bfloat16, torch.float32, "col", True, tmm.TENSOR_CORE),
    (33, torch.bfloat16, torch.bfloat16, "row", True, tmm.TENSOR_CORE),
    (512, torch.bfloat16, torch.float32, "row", False, tmm.CUDA_CORE),
    (512, torch.int8, torch.int8, "col", True, tmm.TENSOR_CORE_INT8),
    (512, torch.int8, torch.int8, "col", False, tmm.CUDA_CORE),
    (512, torch.int8, torch.int8, "row", True, tmm.CUDA_CORE),
    (512, torch.float32, torch.float32, "row", True, tmm.CUDA_CORE),
    (512, torch.float32, torch.bfloat16, "col", True, tmm.CUDA_CORE),
    (32, torch.bfloat16, torch.float32, "row", True, tmm.SPLIT_K),
    (4, torch.int8, torch.int8, "col", True, tmm.SPLIT_K),
    (1, torch.float32, torch.float32, "row", False, tmm.SPLIT_K),
])
def test_route_rule(M, a, b, layout, aligned, want):
    assert tmm.route(M, a, b, layout, aligned) == want


def test_plan_route_takes_the_worst_case_b():
    assert tmm.plan_route(512, torch.bfloat16, "row") == tmm.TENSOR_CORE
    assert tmm.plan_route(512, torch.int8, "col") == tmm.TENSOR_CORE_INT8
    assert tmm.plan_route(512, torch.int8, "row") == tmm.CUDA_CORE
    assert tmm.plan_route(4, torch.bfloat16, "col") == tmm.SPLIT_K


@pytest.mark.parametrize("K,N,layout,dt,offset,want", [
    (2560, 2560, "row", torch.float32, 0, True),
    (1000, 777, "row", torch.float32, 0, False),   # B row stride 3108 bytes
    (1000, 777, "col", torch.float32, 0, True),    # B (N, K): 4000 bytes
    (777, 1000, "row", torch.float32, 0, False),   # A row stride 1554 bytes
    (32, 2560, "row", torch.float32, 0, True),     # rwkv w_lora_b
    (2560, 32, "row", torch.float32, 0, True),     # rwkv w_lora_a
    (2560, 2560, "row", torch.float32, 1, False),  # B base off by 4 bytes
    (2560, 2560, "col", torch.int8, 0, True),
    (2568, 2560, "col", torch.int8, 0, False),     # int8 (N, K): 2568 bytes
])
def test_tma_alignment_rule(K, N, layout, dt, offset, want):
    a = torch.zeros((8, K), dtype=torch.int8 if dt == torch.int8
                    else torch.bfloat16)
    shape = (N, K) if layout == "col" else (K, N)
    flat = torch.zeros(shape[0] * shape[1] + offset, dtype=dt)
    b = flat[offset:].view(shape)
    assert tmm.tma_aligned(a, b) == want


@pytest.mark.parametrize("M,K,N,bk,bn", [
    (4, 2560, 2560, 448, 128), (4, 2560, 6912, 640, 128),
    (4, 2560, 8960, 512, 128), (4, 32, 2560, 32, 64), (4, 2560, 32, 32, 64),
    (32, 1000, 300, 96, 64), (17, 700, 300, 256, 128), (1, 33, 64, 64, 64)])
def test_split_k_partition_covers_k_once_in_order(M, K, N, bk, bn):
    splits, k_per = tmm.split_k(M, K, N, bk, bn, sm_count=132)
    assert k_per % bk == 0 and splits >= 1
    ranges = [(s * k_per, min(K, (s + 1) * k_per)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(lo < hi for lo, hi in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    groups = -(-M // tmm.rows_per_group(M))
    blocks = -(-N // bn) * groups
    assert splits == 1 or blocks * (splits - 1) < tmm.BLOCKS_PER_SM * 132
    # the last block sums the partials in split order: the same bits every
    # time, and the f32 product within the f32 tolerance
    a = torch.from_numpy(RNG.normal(size=(M, K)).astype(np.float32))
    b = torch.from_numpy(RNG.normal(size=(K, N)).astype(np.float32))

    def reduce():
        total = torch.zeros((M, N))
        for lo, hi in ranges:
            total = total + a[:, lo:hi] @ b[lo:hi]
        return total
    first = reduce()
    assert torch.equal(first, reduce())
    want = (a.double() @ b.double()).numpy()
    np.testing.assert_allclose(first.double().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_split_k_tickets_are_kept_zeroed():
    dev = torch.device("cpu")
    t = tmm.tickets(dev, 10)
    assert t.numel() >= 10 and int(t.abs().sum()) == 0
    assert tmm.tickets(dev, 20) is t  # kept: no new buffer, no memset
    big = tmm.tickets(dev, t.numel() + 1)
    assert big.numel() > t.numel() and int(big.abs().sum()) == 0
    tmm._tickets.pop(dev.index)


@pytest.mark.parametrize("route", list(tmm.TILES))
def test_h100_tile_set_is_the_kernels_and_fits(route):
    """The planner offers exactly the route's tiles and stage depth, and
    each fits the shared memory a block may use (232,448 bytes)."""
    bms, bks, bns = H100.candidate_blocks(2, route)
    assert {(bm, bn) for bm in bms for bn in bns} >= set(tmm.TILES[route])
    assert bks == ([tmm.TC_BK[route]] if route in tmm.TC_BK
                   else list(range(32, 1025, 32)))
    b_types = {tmm.TENSOR_CORE: (torch.float32, torch.bfloat16),
               tmm.TENSOR_CORE_INT8: (torch.int8,)}.get(route, (None,))
    for bm, bn in tmm.TILES[route]:
        bk = bks[0]
        for b_dt in b_types:
            assert tmm.smem_bytes(route, bm, bk, bn, b_dt) <= 232_448
        assert H100.working_set(bm, bk, bn, 2, 2, route) == \
            tmm.smem_bytes(route, bm, bk, bn)
    assert H100.working_set(16, 64, 64, 2, 2, tmm.TENSOR_CORE) == float("inf")


def test_h100_tensor_core_smem_model():
    """Stages hold 128 bytes of K a row. Route 1 with an f32 B: 4 stages of
    A, 2 of the staged f32 B and 2 of its three bf16 terms, 1 KB of
    alignment slack, 16 mbarriers; bf16 B and int8: 4 stages of (A, B)."""
    kb = 1024
    assert tmm.smem_bytes(tmm.TENSOR_CORE, 128, 64, 128) == \
        kb + 4 * 16 * kb + 2 * 32 * kb + 2 * 48 * kb + 8 * 16
    assert tmm.smem_bytes(tmm.TENSOR_CORE, 64, 64, 128, torch.bfloat16) == \
        kb + 4 * (8 * kb + 16 * kb) + 8 * 8
    assert tmm.smem_bytes(tmm.TENSOR_CORE_INT8, 128, 128, 128) == \
        kb + 4 * (16 * kb + 16 * kb) + 8 * 8


def test_h100_rate_per_route():
    assert H100.peak_flops(torch.bfloat16, tmm.TENSOR_CORE) == 989e12 / 3
    assert H100.peak_flops(torch.int8, tmm.TENSOR_CORE_INT8) == 1979e12
    assert H100.peak_flops(torch.float32, tmm.CUDA_CORE) == 67e12
    assert H100.peak_flops(torch.bfloat16, tmm.SPLIT_K) == 67e12
    assert H100.peak_flops(torch.int8, tmm.CUDA_CORE) == 67e12 / 2
    assert H100.gemm_route(512, torch.bfloat16, "row") == tmm.TENSOR_CORE
    assert hwregistry.get_hw("tpu_v5e").gemm_route(512, torch.bfloat16) is None


def test_h100_grid_counts_split_k_blocks():
    """M = 4 at bn = 128, N = 2560: 20 column blocks, split into 6 along K
    at bk = 448, so 120 blocks on 132 SMs, not 20."""
    util = pm.grid_utilization(H100, 4, 2560, 32, 128, route=tmm.SPLIT_K,
                               K=2560, bk=448)
    splits, _ = tmm.split_k(4, 2560, 2560, 448, 128, H100.sm_count)
    assert util == pytest.approx(20 * splits / (-(-20 * splits // 132) * 132))
    assert util > pm.grid_utilization(H100, 4, 2560, 32, 128)
