"""Fat GEMM with the fused epilogue: wrapper of the CUDA kernel
``csrc/matmul.cu`` (counterpart of the Pallas kernel
``repro.kernels.matmul.matmul``).

``matmul`` takes the reference's arguments. On a CUDA tensor it launches the
hand-written kernel on one of four routes, which mask ragged M, N and K
edges themselves, so nothing is padded or copied; on a CPU tensor it runs
the plain version (``ref.matmul_ref``); on a meta tensor it only returns the
output's shape (the plan warm-up traces the model there). ``launches``
counts kernel launches and nothing else.

Routes (``route``, a rule on M, the dtypes, B's layout and alignment, taken
before the launch; the source's header says what bounds each):

* ``tensor_core``: bf16 A x f32 or bf16 B, M > 32, TMA-aligned. wgmma fed by
  TMA; an f32 B is split into three bf16 terms (``ref.split_bf16x3``).
* ``split_k``: M <= 32, any dtypes. B streams once; K is split across
  blocks, the last block of a tile sums the partials and runs the epilogue.
* ``tensor_core_int8``: int8 x int8 with B col layout, M > 32, aligned.
* ``cuda_core``: everything else (f32 A, int8 row, unaligned strides or
  pointers): f32 / i32 FMAs on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

TENSOR_CORE = "tensor_core"
SPLIT_K = "split_k"
TENSOR_CORE_INT8 = "tensor_core_int8"
CUDA_CORE = "cuda_core"
ROUTE_CODE = {TENSOR_CORE: 1, SPLIT_K: 2, TENSOR_CORE_INT8: 3, CUDA_CORE: 4}

SPLIT_K_M = 32  # at most this many rows take the split-K route

# (bm, bn) output tiles each route is instantiated for (csrc/matmul.cu):
# tensor cores: one or two consumer warpgroups of 64 rows, wgmma n128;
# split-K: bm is the route's row limit (rows go 8 to a block); CUDA cores:
# a 16 x 16 thread grid, at most 64 accumulators a thread.
TILES = {
    TENSOR_CORE: ((64, 128), (128, 128)),
    TENSOR_CORE_INT8: ((64, 128), (128, 128)),
    SPLIT_K: ((SPLIT_K_M, 64), (SPLIT_K_M, 128)),
    CUDA_CORE: ((16, 64), (16, 128), (32, 64), (32, 128),
                (64, 64), (64, 128), (128, 64), (128, 128)),
}
# K of one pipeline stage of a tensor-core route (128 bytes of K: one
# swizzled row); the other routes take any positive multiple of BK_STEP
TC_BK = {TENSOR_CORE: 64, TENSOR_CORE_INT8: 128}
BK_STEP = 32

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.int16: 3, torch.int32: 4}
ACT_CODE = {None: 0, "none": 0, "relu": 1, "relu2": 2, "gelu": 3, "silu": 4}
IN_TYPES = ((torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
            (torch.int8, torch.int8))

# split-K (and the GEMV's): split K until the grid holds about this many
# blocks per SM
BLOCKS_PER_SM = 2
THREADS = 256  # split-K and CUDA-core blocks

launches = 0


def route(M: int, a_dtype: torch.dtype, b_dtype: torch.dtype,
          b_layout: str, aligned: bool = True) -> str:
    """The kernel route of one call. ``aligned``: A's and B's base pointers
    and row strides are 16-byte multiples (TMA needs both)."""
    if M <= SPLIT_K_M:
        return SPLIT_K
    if aligned and a_dtype == torch.bfloat16 and b_dtype in (
            torch.float32, torch.bfloat16):
        return TENSOR_CORE
    if (aligned and a_dtype == torch.int8 and b_dtype == torch.int8
            and b_layout == "col"):
        return TENSOR_CORE_INT8
    return CUDA_CORE


def plan_route(M: int, a_dtype: torch.dtype, b_layout: str) -> str:
    """The route a plan is solved for: the plan key records A's dtype only,
    so B is taken as its worst case (f32 for a float A) and aligned."""
    b_dtype = torch.int8 if a_dtype == torch.int8 else torch.float32
    return route(M, a_dtype, b_dtype, b_layout)


def tma_aligned(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Base pointers and row strides of contiguous A and B on 16 bytes."""
    b_row = b.shape[1] * b.element_size()  # (K,N) row or (N,K) col: last dim
    return (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and (a.shape[1] * a.element_size()) % 16 == 0 and b_row % 16 == 0)


def rows_per_group(M: int) -> int:
    """Rows one split-K (or GEMV) block keeps in registers (csrc ROWS); more
    rows go to further grid groups, each streaming B again."""
    return 1 if M <= 1 else 2 if M <= 2 else 4 if M <= 4 else 8


def split_k(M: int, K: int, N: int, bk: int, bn: int, sm_count: int
            ) -> tuple[int, int]:
    """(splits, k_per_split) for a grid of ceil(N/bn) x groups blocks: split
    K (in whole bk steps) until the grid holds ~BLOCKS_PER_SM blocks/SM."""
    blocks = -(-N // bn) * -(-M // rows_per_group(M))
    k_steps = -(-K // bk)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // blocks))
    splits = min(k_steps, want)
    k_per_split = -(-k_steps // splits) * bk
    return -(-K // k_per_split), k_per_split


def valid_bk(r: str, bk: int) -> bool:
    if r in TC_BK:
        return bk == TC_BK[r]
    return bk > 0 and bk % BK_STEP == 0


def smem_bytes(r: str, bm: int, bk: int, bn: int,
               b_dtype: torch.dtype | None = None) -> int:
    """Dynamic shared memory of one block of route ``r`` (csrc/matmul.cu);
    ``b_dtype`` None takes the route's worst case.

    * tensor_core: 1 KB alignment slack, 4 stages of the A tile (128 bytes
      of K a row) and, for a bf16 B, its tile beside each; for an f32 B,
      2 stages of the staged f32 tile and 2 of its three bf16 terms; plus
      the mbarriers.
    * tensor_core_int8: 4 stages of (A tile + B tile).
    * split_k: the A rows of one bk slice and the row layout's reduction
      buffer, at the most rows a block holds (8) and 16-byte vectors.
    * cuda_core: the A and B slices of one bk step in the 4-byte
      accumulator type, rows padded by one.
    """
    if r in TC_BK:
        tile = bn * 128  # one bf16 (int8) B tile of a stage
        if r == TENSOR_CORE and b_dtype in (None, torch.float32):
            return (1024 + 4 * bm * 128 + 2 * 64 * bn * 4 + 2 * 3 * tile
                    + 8 * 2 * (4 + 2 + 2))
        return 1024 + 4 * (bm * 128 + tile) + 8 * 2 * 4
    if r == SPLIT_K:
        rows, vec = 8, 8
        return (rows * bk + THREADS * rows * vec) * 4
    return bk * ((bm + 1) + (bn + 1)) * 4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_matmul.argtypes = [p, p, p, p, p, p, p] + [i] * 15 + [p]
    lib.repro_matmul.restype = i
    return lib


@functools.cache
def _props(index: int):
    return torch.cuda.get_device_properties(index)


_tickets: dict[int, torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []


def grow_tickets(store: dict[int, torch.Tensor], device: torch.device,
                 n: int) -> torch.Tensor:
    """At least ``n`` zeroed split-K tickets for ``device`` from ``store``,
    kept across calls: the last block of each tile resets its own, so no
    memset runs per call (one stream: launches on it are ordered).

    A CUDA graph bakes in the buffer's address, so an outgrown buffer is
    kept alive (a captured step may still name it), and growing while a
    graph is being captured raises: the step's eager run before capture
    sizes the buffer for every launch of that step."""
    t = store.get(device.index)
    if t is None or t.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"split-K tickets grow from "
                f"{0 if t is None else t.numel()} to {n} during CUDA graph "
                "capture: run the step eagerly once before capturing it")
        if t is not None:
            _outgrown.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        store[device.index] = t
    return t


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """The fat GEMM's split-K tickets (:func:`grow_tickets`)."""
    return grow_tickets(_tickets, device, n)


def _check(a, b, bias, out_scale, *, M, K, N, bm, bk, bn, out_dtype,
           activation, r) -> None:
    dev = a.device
    for name, t in (("b", b), ("bias", bias), ("out_scale", out_scale)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
    if (a.dtype, b.dtype) not in IN_TYPES:
        raise TypeError(f"matmul kernel takes (A, B) dtypes {IN_TYPES}, "
                        f"got ({a.dtype}, {b.dtype})")
    if out_dtype not in DTYPE_CODE:
        raise TypeError(f"matmul kernel has no {out_dtype} output")
    if activation not in ACT_CODE:
        raise ValueError(f"unknown activation {activation!r}")
    if (a.dtype == torch.int8 and out_scale is None
            and activation in ("gelu", "silu")):
        raise ValueError(f"{activation} on an int32 accumulator needs "
                         "out_scale (the kernel applies it in f32)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel needs contiguous A and B")
    for name, t in (("bias", bias), ("out_scale", out_scale)):
        if t is not None and (t.shape != (N,) or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 ({N},), got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (bm, bn) not in TILES[r] or not valid_bk(r, bk):
        raise ValueError(f"no {r} kernel for tile (bm={bm}, bk={bk}, "
                         f"bn={bn}): (bm, bn) in {TILES[r]}, bk "
                         + (f"= {TC_BK[r]}" if r in TC_BK
                            else f"a multiple of {BK_STEP}"))
    if (max(M * K, K * N, M * N) >= 2**31
            or max(-(-M // bm), -(-N // bn)) > 65535):
        raise ValueError(f"GEMM ({M}, {K}, {N}) exceeds the kernel's "
                         "32-bit index and grid limits")
    need = smem_bytes(r, bm, bk, bn, b.dtype)
    have = _props(dev.index).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"{r} tile ({bm}, {bk}, {bn}) needs {need} bytes "
                         f"of shared memory, the device allows {have}")


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype: torch.dtype | None = None,
    b_layout: str = "row",
    activation: str | None = None,
) -> torch.Tensor:
    """C[M,N] = act(A[M,K] @ B * out_scale + bias), B (K,N) row or (N,K) col.

    Semantics of :func:`repro_torch.kernels.ref.matmul_ref`. The blocks are
    the plan's, for the route :func:`route` picks; M, K and N need not be
    multiples of them.
    """
    global launches
    if out_dtype is None:
        out_dtype = a.dtype
    if b_layout not in ("row", "col"):
        raise ValueError(f"b_layout must be 'row' or 'col', got {b_layout!r}")
    M, K = a.shape
    N, Kb = b.shape if b_layout == "col" else b.shape[::-1]
    if Kb != K:
        raise ValueError(f"contraction mismatch: A has K={K}, B has K={Kb}")
    if a.device.type == "meta":
        return torch.empty((M, N), dtype=out_dtype, device="meta")
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype=out_dtype, b_layout=b_layout,
                              bias=bias, activation=activation,
                              out_scale=out_scale)
    if a.device.type != "cuda":
        raise ValueError(f"matmul kernel runs on cuda, not {a.device}")
    dev = a.device
    r = route(M, a.dtype, b.dtype, b_layout, tma_aligned(a, b))
    _check(a, b, bias, out_scale, M=M, K=K, N=N, bm=bm, bk=bk, bn=bn,
           out_dtype=out_dtype, activation=activation, r=r)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    splits, k_per_split, ws, tk, vec_ok = 1, K, None, None, 0
    if r == SPLIT_K:
        splits, k_per_split = split_k(M, K, N, bk, bn,
                                      _props(dev.index).multi_processor_count)
        if splits > 1:
            ws = torch.empty((splits, M, N), dtype=ref.acc_dtype(a.dtype),
                             device=dev)
            tk = tickets(dev, -(-N // bn) * -(-M // rows_per_group(M)))
        vec = 8 if b.dtype == torch.int8 else 16 // b.element_size()
        vec_ok = int((b.shape[1] % vec == 0)
                     and b.data_ptr() % (vec * b.element_size()) == 0)
    err = _lib().repro_matmul(
        a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if out_scale is None else out_scale.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if tk is None else tk.data_ptr(), M, K, N, bm, bk, bn,
        DTYPE_CODE[a.dtype], DTYPE_CODE[b.dtype], DTYPE_CODE[out_dtype],
        int(b_layout == "col"), ACT_CODE[activation], ROUTE_CODE[r], splits,
        k_per_split, vec_ok, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"repro_matmul ({r})")
    launches += 1
    return out
