"""The WKV kernel's Python side (``repro_torch.kernels.wkv``), on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` phase 3b
holds it against its plain version); what surrounds it is checked here:

* ``wkv_msplit_ref``, the kernel's algebra (every slice of ``ms`` value
  columns on its own, recomputing the cumsum, the decay-scaled tiles, A and
  the bonus diagonal), against the JAX package's Pallas kernel run in
  interpret mode, on the reference test's shapes at rtol = atol = 2e-4 and
  on its adversarial decay range at 1e-3 (``tests/test_kernels_wkv.py``'s
  own tolerances);
* ``wkv_heads``, the (B, T, H, N) wrapper ``time_mix`` calls: on the CPU it
  gives the bits of ``wkv`` on the (B*H, T, N) f32 copies, it runs on the
  meta device, and it refuses what the kernel cannot take;
* the partition (slice width ``ms`` and grid): every value column once,
  one wave of 132 SMs at the path shape, shared memory that fits;
* the load route (16-byte cp.async, or element loads);
* that tools/wkv_probe.py's text edits still apply to the kernel source.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import wkv as RK
from repro_torch.kernels import wkv as TK

t = torch.from_numpy
WKV_SHAPES = [(1, 1, 32, 64), (2, 3, 128, 64), (1, 2, 96, 128)]
SM_COUNT = 132
SMEM_OPTIN = 232_448  # shared memory a block may use on an H100


def _inputs(B, H, T, N, seed=0, w0_range=(-6, 1)):
    """As tests/test_kernels_wkv.py makes them, in the (B*H, T, N) layout,
    u one row per (b, h)."""
    rng = np.random.default_rng(seed)
    r, k, v = [rng.normal(size=(B * H, T, N)).astype(np.float32)
               for _ in range(3)]
    wl = (-np.exp(rng.uniform(*w0_range, size=(B * H, T, N)))).astype(
        np.float32)
    u = (rng.normal(size=(H, N)) * 0.3).astype(np.float32)
    u_rows = np.array(np.broadcast_to(u[None], (B, H, N)).reshape(B * H, N))
    s0 = (rng.normal(size=(B * H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, wl, u_rows, s0


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------- the split's algebra
@pytest.mark.parametrize("ms", [16, 32])
@pytest.mark.parametrize("B,H,T,N", WKV_SHAPES)
def test_msplit_ref_matches_reference_kernel(B, H, T, N, ms):
    args = _inputs(B, H, T, N, seed=B * 7 + T)
    want_y, want_s = RK.wkv(*map(jnp.asarray, args), interpret=True)
    got_y, got_s = TK.wkv_msplit_ref(*map(t, args), ms=ms)
    assert got_y.shape == (B * H, T, N) and got_s.shape == (B * H, N, N)
    _close(got_y, want_y, 2e-4)
    _close(got_s, want_s, 2e-4)


@pytest.mark.parametrize("ms", [16, 32])
def test_msplit_ref_adversarial_decay(ms):
    """Decays down to e^-3.3 a step, re-centred over a chunk: the factored
    exponentials lose a few more bits, hence the reference test's 1e-3."""
    args = _inputs(1, 2, 64, 32, seed=3, w0_range=(-8, 1.2))
    want_y, want_s = RK.wkv(*map(jnp.asarray, args), interpret=True)
    got_y, got_s = TK.wkv_msplit_ref(*map(t, args), ms=ms)
    _close(got_y, want_y, 1e-3)
    _close(got_s, want_s, 1e-3)


def test_msplit_ref_rejects_a_slice_that_does_not_divide_N():
    args = _inputs(1, 1, 32, 32)
    with pytest.raises(ValueError, match="ms=24"):
        TK.wkv_msplit_ref(*map(t, args), ms=24)


# ------------------------------------------------------- wkv_heads
def _heads(B, T, H, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = [t(rng.normal(size=(B, T, H, N)).astype(np.float32)).to(dtype)
               for _ in range(3)]
    log_w = t((-np.exp(rng.uniform(-6, 1, size=(B, T, H, N)))).astype(
        np.float32))
    u = t((rng.normal(size=(H, N)) * 0.3).astype(np.float32))
    s0 = t((rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32))
    return r, k, v, log_w, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,N", [(2, 64, 4, 16), (1, 96, 2, 64),
                                     (2, 32, 3, 32)])
def test_wkv_heads_on_cpu_is_wkv_on_the_copies(B, T, H, N, dtype):
    r, k, v, log_w, u, s0 = _heads(B, T, H, N, dtype, seed=B + T)
    launches = TK.launches
    y, s = TK.wkv_heads(r, k, v, log_w, u, s0)
    assert TK.launches == launches  # the plain version is not a launch
    assert y.shape == (B, T, H, N) and y.dtype == torch.float32
    assert s.shape == (B, H, N, N) and s.dtype == torch.float32
    to_bh = lambda x: x.float().transpose(1, 2).reshape(B * H, T, N)
    want_y, want_s = TK.wkv(to_bh(r), to_bh(k), to_bh(v), to_bh(log_w),
                            u[None].expand(B, H, N).reshape(B * H, N),
                            s0.reshape(B * H, N, N))
    assert torch.equal(y, want_y.reshape(B, H, T, N).transpose(1, 2))
    assert torch.equal(s, want_s.reshape(B, H, N, N))


def test_wkv_heads_matches_reference_kernel():
    B, T, H, N = 2, 64, 3, 32
    r, k, v, log_w, u, s0 = _heads(B, T, H, N, torch.float32, seed=5)
    y, s = TK.wkv_heads(r, k, v, log_w, u, s0)
    bh = lambda x: x.transpose(1, 2).reshape(B * H, T, N).numpy()
    want_y, want_s = RK.wkv(
        *map(jnp.asarray, (bh(r), bh(k), bh(v), bh(log_w),
                           np.array(np.broadcast_to(
                               u.numpy()[None], (B, H, N)).reshape(B * H, N)),
                           s0.reshape(B * H, N, N).numpy())), interpret=True)
    _close(bh(y), want_y, 2e-4)
    _close(s.reshape(B * H, N, N), want_s, 2e-4)


def test_wkv_heads_on_meta_gives_shapes_only():
    args = [x.to("meta") for x in _heads(4, 128, 40, 64, torch.bfloat16)]
    y, s = TK.wkv_heads(*args)
    assert y.device.type == s.device.type == "meta"
    assert y.shape == (4, 128, 40, 64) and y.dtype == torch.float32
    assert s.shape == (4, 40, 64, 64) and s.dtype == torch.float32


def _broken(case):
    r, k, v, log_w, u, s0 = _heads(1, 64, 2, 16, torch.float32)
    if case == "ragged T":
        cut = lambda x: x[:, :60]
        return (cut(r), cut(k), cut(v), cut(log_w), u, s0), "multiple"
    if case == "wrong shape":
        return (r, k, v, log_w[:, :, :1], u, s0), "log_w must be"
    if case == "state shape":
        return (r, k, v, log_w, u, s0[:, :, :8]), "state must be"
    if case == "stride along N":
        kt = k.transpose(2, 3).contiguous().transpose(2, 3)
        return (r, kt, v, log_w, u, s0), "unit stride"
    if case == "mixed device":
        return (r, k, v.to("meta"), log_w, u, s0), "on meta"
    if case == "mixed dtype":
        return (r, k.bfloat16(), v, log_w, u, s0), "share"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["ragged T", "wrong shape", "state shape",
                                  "stride along N", "mixed device",
                                  "mixed dtype"])
def test_wkv_heads_rejects(case):
    args, match = _broken(case)
    with pytest.raises(ValueError, match=match):
        TK.wkv_heads(*args)


def test_wkv_rejects_ragged_T_and_a_head_size_the_kernel_lacks():
    args = [t(x[:, :30].copy()) if x.ndim == 3 and x.shape[1] == 32 else t(x)
            for x in _inputs(1, 1, 32, 64)]
    with pytest.raises(ValueError, match="multiple"):
        TK.wkv(*args)
    with pytest.raises(ValueError, match="N in"):
        TK.partition(160, 48, SM_COUNT)


# ------------------------------------------------------- partition
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("BH", [1, 2, 8, 160, 1000])
@pytest.mark.parametrize("N", TK.HEAD_SIZES)
def test_partition_covers_every_value_column_once(N, BH, itemsize):
    p = TK.partition(BH, N, SM_COUNT, itemsize)
    assert p.ms in TK.SLICES and p.ms <= N
    assert p.slices * p.ms == N and p.blocks == BH * p.slices
    cols = [m0 + m for m0 in range(0, N, p.ms) for m in range(p.ms)]
    assert sorted(cols) == list(range(N))
    assert p.per_sm == -(-p.blocks // SM_COUNT) and p.resident >= 1


def test_partition_at_the_path_shape_fills_a_wave_three_blocks_an_SM():
    """rwkv6-3b's prefill: 4 x 40 heads of 64, bf16 r, k, v."""
    p = TK.partition(4 * 40, 64, SM_COUNT, itemsize=2)
    assert p.blocks >= SM_COUNT
    assert p.resident >= 3
    assert p.blocks <= SM_COUNT * p.resident  # one wave
    assert p.ms == 32
    # a few rows take the narrow slice: one block an SM sets the pace
    assert TK.partition(2, 128, SM_COUNT, itemsize=4).ms == 16


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N,ms", [(N, ms) for N in TK.HEAD_SIZES
                                  for ms in TK.SLICES if ms <= N])
def test_smem_fits_the_opt_in(N, ms, itemsize):
    assert TK.smem_bytes(N, ms, itemsize) <= SMEM_OPTIN
    if N == 64:  # the path's heads: bf16 r, k, v; f32 from wkv's layout
        assert TK.blocks_per_sm(N, ms, itemsize) >= (3 if itemsize == 2 else 2)


def test_smem_bytes_is_the_kernels_layout():
    """csrc/wkv.cu Layout at N = 64, ms = 32, bf16: staging 2 x 4608 (r, k,
    rows of 144 bytes) + 8704 (wl, rows of 68) + 2048 (v); tiles 3 x 8192
    + 8704; v 4096; state 8192; A 4096; D's partials 1024; D, CE, MID, U
    128 + 3 x 256."""
    assert TK.smem_bytes(64, 32, 2) == (9216 + 8704 + 2048 + 3 * 8192 + 8704
                                        + 4096 + 8192 + 4096 + 1024 + 128
                                        + 768)
    assert TK.smem_bytes(64, 32, 2) == 71_552


# ----------------------------------------------------------- route
@pytest.mark.parametrize("layouts,want", [
    # (B, T, H, N) bf16 views of a (B, T, 2560) projection
    ([(1 << 20, (128 * 2560, 64, 2560), 2)] * 3
     + [(1 << 21, (128 * 2560, 64, 2560), 4)], TK.VECTOR),
    # (B*H, T, N) f32, the b stride 0
    ([(4096, (0, 128 * 64, 64), 4)] * 4, TK.VECTOR),
    # a base one bf16 element off
    ([(4098, (0, 128 * 64, 64), 2)], TK.SCALAR),
    # a row stride of 20 bf16 (40 bytes)
    ([(4096, (0, 20 * 32, 20), 2)], TK.SCALAR),
    # N = 16 bf16 heads of a 3 x 16 projection: a row of 96 bytes, a head 32
    ([(4096, (32 * 48, 16, 48), 2)], TK.VECTOR),
    # an f32 head stride of 6 elements (24 bytes)
    ([(4096, (0, 6, 64), 4)], TK.SCALAR),
])
def test_route(layouts, want):
    assert TK.route(layouts) == want


def test_route_of_real_tensors():
    x = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16)
    lay = lambda a: (a.data_ptr(), (a.stride(0), a.stride(2), a.stride(1)),
                     a.element_size())
    assert TK.route([lay(x)]) == (TK.VECTOR if x.data_ptr() % 16 == 0
                                  else TK.SCALAR)
    odd = torch.zeros(2 * 64 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(
        2, 64, 4, 16)
    assert TK.route([lay(odd)]) == TK.SCALAR


# ----------------------------------------------------------- probe
@pytest.mark.parametrize("variant", ["base", "noP1", "noP2", "noP3", "noP4",
                                     "empty", "stamps"])
def test_probe_edits_apply_to_the_kernel(variant):
    """tools/wkv_probe.py builds its variants by text edits of csrc/wkv.cu;
    each edit must still match the source once."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "wkv_probe.py")
    spec = importlib.util.spec_from_file_location("wkv_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = probe.variant_source(variant)
    base = open(probe.SRC).read()
    assert (src == base) == (variant == "base")
    if variant == "stamps":
        assert src.count("clock64()") == len(probe.STAMPS) + 1
