"""Skinny decode GEMM (GEMV): wrapper of the CUDA kernel
``csrc/decode_matvec.cu`` (counterpart of the Pallas kernel
``repro.kernels.decode_matvec.decode_matvec``).

``out[B,N] = x[B,K] @ W`` with B <= 128, W (K,N) row or (N,K) col, no
epilogue. On a CUDA tensor it launches the kernel, which masks ragged
edges (W is never padded or copied); on a CPU tensor it runs the plain
version (``ref.gemv_ref``); on a meta tensor it returns the output's shape
only; on a CUDA tensor that requires grad (grad mode on) it raises:
gradients go through ``core.gemm.balanced_gemm``. ``launches`` counts
kernel launches and nothing else: one a call.

Routes (``route``, a rule on W's alignment, taken before the launch):

* ``tma``: W's base pointer and contiguous row stride are 16-byte
  multiples. A producer warp streams W once, for all B rows, through a
  64 KB ring of TMA stages; x is staged once a block for the block's whole
  K range. The consumers run on the tensor cores for a bf16 x, row layout
  and 8 < B <= 128 (``mma_tiles``), else on the CUDA cores
  (``tma_threads`` says how the threads share rows and columns).
* ``cuda_core``: W unaligned. The CUDA-core kernels of the first port.

Split-K: the (bk, bn) blocks come from the planner; ``partition`` splits K
so that the grid fills the SMs, and caps the split so that the block's x
slice fits beside the ring. Each split writes an f32/i32 partial into
scratch this wrapper allocates, and the last block of each column tile
(an atomic ticket, ``tickets``) sums the partials in split order in the
same launch, so the result does not depend on scheduling.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.matmul import (  # noqa: F401 (re-exported)
    BK_STEP, BLOCKS_PER_SM, DTYPE_CODE, IN_TYPES, grow_tickets,
    rows_per_group, split_k)

MAX_ROWS = 128
THREADS = 256  # consumer threads of a tma block; threads of a cuda_core one

TMA = "tma"
CUDA_CORE = "cuda_core"
ROUTE_CODE = {TMA: 1, CUDA_CORE: 2}

TMA_BN = (64, 128)           # columns a tma block owns (the planner's bn)
RING_BYTES = 64 * 1024       # W in flight per tma block, in 16 KB or less stages
MAX_STAGE_BYTES = 16 * 1024
COL_STAGE_BYTES = 128        # K bytes of one col-layout stage row (swizzle span)
SM_RESERVED = 1024           # shared memory the card keeps per block
ALIGN_SLACK = 1024           # the kernel aligns its ring to 1024 bytes
MMA_ROWS = (8, 128)          # B range of the tensor-core consumers
# a block's fixed cost (its share of the ramp, the partial it writes and
# the tail it may sum), in bytes of W streamed: set on the H100 so that the
# path's B = 4 shapes take the fastest of the partitions measured
BLOCK_COST = 256 * 1024

launches = 0


def vec_elems(w_dtype: torch.dtype) -> int:
    """W elements per vector load of a row-layout thread: 16 bytes (8 bytes
    for int8)."""
    return 8 if w_dtype == torch.int8 else 16 // w_dtype.itemsize


def route(w: torch.Tensor, w_layout: str) -> str:
    """``tma`` when W's base and its contiguous row stride are 16-byte
    multiples (TMA addresses nothing else), else ``cuda_core``."""
    row_bytes = w.shape[1] * w.element_size()  # (K,N) row / (N,K) col
    if w.data_ptr() % 16 == 0 and row_bytes % 16 == 0:
        return TMA
    return CUDA_CORE


def tma_threads(B: int, bn: int, w_dtype: torch.dtype, w_layout: str
                ) -> tuple[int, int]:
    """(rt, cpt): rows and columns one consumer thread holds.

    row: a thread holds rt rows of one vector of columns; rt is B rounded up
    to a power of two, at most 8, or 16 where ceil(B / 8) row groups would
    not find a lane (f32 W, 4-wide vectors, bn = 128 and B > 64); cpt is 1.
    col: rt is B rounded up to a power of two, at most 8; cpt columns (a
    power of two) so that (bn / cpt) column lanes x row groups fit the 256
    threads.
    """
    p2 = 1 << (B - 1).bit_length()
    if w_layout == "row":
        lanes = THREADS // (bn // vec_elems(w_dtype))  # threads a column
        rt = min(p2, 8)
        return (16 if -(-B // rt) > lanes else rt), 1
    rt = min(p2, 8)
    groups = -(-B // rt)
    need = -(-bn * groups // THREADS)
    return rt, 1 << (need - 1).bit_length()


def mma_tiles(B: int, x_dtype: torch.dtype, w_layout: str) -> int:
    """Row tiles of 16 the tensor-core consumers take (a power of two), or
    0 for the CUDA-core consumers: the tensor cores take a bf16 x with a
    row-layout W at MMA_ROWS[0] < B <= MMA_ROWS[1]. At 8 rows or fewer W's
    bytes bound the call either way."""
    if (x_dtype != torch.bfloat16 or w_layout != "row"
            or not MMA_ROWS[0] < B <= MMA_ROWS[1]):
        return 0
    return 1 << (-(-B // 16) - 1).bit_length()


def stage_k(w_layout: str, w_dtype: torch.dtype, bn: int,
            k_per_split: int) -> int:
    """K of one ring stage: col, 128 bytes of K (the swizzle span); row, the
    most rows (a power of two, 32..256) of at most 16 KB that divide the
    split, so that only the last stage of K is ragged."""
    if w_layout == "col":
        return COL_STAGE_BYTES // w_dtype.itemsize
    sk = 256
    while sk > BK_STEP and (sk * bn * w_dtype.itemsize > MAX_STAGE_BYTES
                            or k_per_split % sk):
        sk //= 2
    return sk


def x_row_bytes(kx: int, x_size: int) -> int:
    """Bytes of one staged x row (csrc x_row_bytes): 16-byte multiple, plus
    16 so that rows read side by side start in other banks."""
    return -(-kx * x_size // 16) * 16 + 16


def tma_smem_bytes(x_rows: int, kx: int, x_size: int, stages: int) -> int:
    """Dynamic shared memory of one tma block: alignment slack, the ring,
    the x slice (x_rows rows of kx elements), the mbarriers."""
    return (ALIGN_SLACK + RING_BYTES + x_rows * x_row_bytes(kx, x_size)
            + 16 * stages)


def core_smem_bytes(B: int, bk: int, bn: int, w_dtype: torch.dtype,
                    w_layout: str) -> int:
    """Dynamic shared memory of one cuda_core block: a bk slice of its rows
    and, in the row layout, the k-lane reduction (csrc core::launch)."""
    rows = rows_per_group(B)
    red = 0 if w_layout == "col" else THREADS * rows * vec_elems(w_dtype)
    return (rows * bk + red) * 4


def _steps(bk: int) -> list[int]:
    """Split granularities, largest first: bk, then its divisors that are
    multiples of BK_STEP."""
    return [g for g in range(bk, 0, -BK_STEP) if bk % g == 0]


@functools.cache
def partition(B: int, K: int, N: int, bk: int, bn: int, sm_count: int,
              smem_budget: int, *, w_size: int = 4, x_size: int = 2,
              x_rows: int = 0, k_stage: int = BK_STEP, fixed_smem: int = 0,
              groups: int = 1, blocks_per_sm: int = BLOCKS_PER_SM
              ) -> tuple[int, int]:
    """(splits, k_per_split) of the GEMV's grid of ceil(N/bn) x groups
    column tiles x splits.

    * The splits cover K once, in order: k_per_split is a multiple of a
      step g and splits = ceil(K / k_per_split). g is bk itself unless a
      divisor of bk (a multiple of BK_STEP) gives a better grid: at
      N = 2560 a bk of 448 allows 6 splits of 20 tiles, 120 blocks on 132
      SMs.
    * A block's x slice (x_rows rows of k_per_split, rounded up to k_stage,
      elements of x_size bytes) plus ``fixed_smem`` must leave
      ``blocks_per_sm`` blocks on an SM of (smem_budget + SM_RESERVED)
      bytes per block slot (two: the tma kernels' __launch_bounds__).
    * The grid holds at least sm_count blocks where the splits allow it.
      Among such partitions the least modeled HBM traffic wins: whole waves
      of blocks_per_sm x sm_count slots, each slot streaming one block's W
      plus a fixed BLOCK_COST, and the partials written and read once.
    """
    tiles = -(-N // bn) * groups
    per_block = (smem_budget + SM_RESERVED) // blocks_per_sm - SM_RESERVED
    slots = blocks_per_sm * sm_count
    best = None
    for g in _steps(bk):
        for per in range(-(-K // g), 0, -1):
            kps = per * g
            splits = -(-K // kps)
            kx = -(-kps // k_stage) * k_stage
            if fixed_smem + x_rows * x_row_bytes(kx, x_size) > per_block:
                continue
            blocks = tiles * splits
            cost = (-(-blocks // slots) * slots * (kps * bn * w_size
                                                   + BLOCK_COST)
                    + (splits > 1) * splits * B * N * 8)
            key = (min(blocks, sm_count), -cost, g)
            if best is None or key > best[0]:
                best = (key, splits, kps)
    if best is None:
        raise ValueError(f"no K split of ({B}, {K}, {N}) fits {per_block} "
                         "bytes of shared memory a block")
    return best[1], best[2]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What one GEMV launch runs: the route, the K partition and, on the
    tma route, the consumer threads' shares and the ring."""

    route: str
    splits: int
    k_per_split: int
    rt: int = 0
    cpt: int = 0
    mt: int = 0
    stage_k: int = 0
    stages: int = 0
    smem: int = 0


@functools.cache
def launch_plan(B: int, K: int, N: int, bk: int, bn: int,
                x_dtype: torch.dtype, w_dtype: torch.dtype, w_layout: str,
                r: str, sm_count: int, smem_budget: int) -> LaunchPlan:
    """The launch of route ``r`` for the planner's (bk, bn) on a card of
    ``sm_count`` SMs and ``smem_budget`` bytes of shared memory a block."""
    if r == CUDA_CORE:
        smem = core_smem_bytes(B, bk, bn, w_dtype, w_layout)
        splits, kps = partition(B, K, N, bk, bn, sm_count, smem_budget,
                                w_size=w_dtype.itemsize, fixed_smem=smem,
                                groups=-(-B // rows_per_group(B)))
        return LaunchPlan(r, splits, kps, smem=smem)
    mt = mma_tiles(B, x_dtype, w_layout)
    rt, cpt = (0, 0) if mt else tma_threads(B, bn, w_dtype, w_layout)
    x_rows = 16 * mt if mt else -(-B // rt) * rt
    x_size = x_dtype.itemsize
    # the col stage is fixed; a row stage divides the split, >= BK_STEP
    k_stage = stage_k(w_layout, w_dtype, bn, BK_STEP)
    stages_max = RING_BYTES // (bn * COL_STAGE_BYTES if w_layout == "col"
                                else BK_STEP * bn * w_dtype.itemsize)
    splits, kps = partition(B, K, N, bk, bn, sm_count, smem_budget,
                            w_size=w_dtype.itemsize, x_size=x_size,
                            x_rows=x_rows, k_stage=k_stage,
                            fixed_smem=ALIGN_SLACK + RING_BYTES
                            + 16 * stages_max)
    sk = stage_k(w_layout, w_dtype, bn, kps)
    stage_bytes = (bn * COL_STAGE_BYTES if w_layout == "col"
                   else sk * bn * w_dtype.itemsize)
    stages = RING_BYTES // stage_bytes
    kx = -(-kps // sk) * sk
    return LaunchPlan(r, splits, kps, rt=rt, cpt=cpt, mt=mt, stage_k=sk,
                      stages=stages,
                      smem=tma_smem_bytes(x_rows, kx, x_size, stages))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_matvec")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_decode_matvec.argtypes = [p, p, p, p, p] + [i] * 19 + [p]
    lib.repro_decode_matvec.restype = i
    return lib


@functools.cache
def _props(index: int):
    return torch.cuda.get_device_properties(index)


_tickets: dict[int, torch.Tensor] = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """The GEMV's split-K tickets (``matmul.grow_tickets``)."""
    return grow_tickets(_tickets, device, n)


def _check(x, w, *, B, K, N, bk, bn, out_dtype, r) -> None:
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if (x.dtype, w.dtype) not in IN_TYPES:
        raise TypeError(f"gemv kernel takes (x, W) dtypes {IN_TYPES}, "
                        f"got ({x.dtype}, {w.dtype})")
    if out_dtype not in DTYPE_CODE:
        raise TypeError(f"gemv kernel has no {out_dtype} output")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemv kernel needs contiguous x and W")
    if not 0 < B <= MAX_ROWS:
        raise ValueError(f"gemv kernel takes 1..{MAX_ROWS} rows, got {B}")
    if bk <= 0 or bk % BK_STEP:
        raise ValueError(f"no gemv kernel for bk={bk}: a multiple of "
                         f"{BK_STEP}")
    if r == TMA and bn not in TMA_BN:
        raise ValueError(f"no tma gemv kernel for bn={bn}: one of {TMA_BN}")
    vec = vec_elems(w.dtype)
    lanes = bn // vec  # column lanes of one cuda_core block (row layout)
    if r == CUDA_CORE and (bn % vec or lanes == 0 or THREADS % lanes):
        raise ValueError(f"no gemv kernel for bn={bn} with {w.dtype} W: "
                         f"bn/{vec} dividing {THREADS}")
    if max(B * K, K * N) >= 2**31 or -(-N // bn) >= 2**31:
        raise ValueError(f"GEMV ({B}, {K}, {N}) exceeds 32-bit indexing")


def decode_matvec(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    bk: int,
    bn: int,
    out_dtype: torch.dtype | None = None,
    w_layout: str = "row",
) -> torch.Tensor:
    """out[B,N] = x[B,K] @ W, W (K,N) row- or (N,K) col-major; B small."""
    global launches
    if out_dtype is None:
        out_dtype = x.dtype
    if w_layout not in ("row", "col"):
        raise ValueError(f"w_layout must be 'row' or 'col', got {w_layout!r}")
    B, K = x.shape
    N, Kw = w.shape if w_layout == "col" else w.shape[::-1]
    if Kw != K:
        raise ValueError(f"contraction mismatch: x has K={K}, W has K={Kw}")
    if x.device.type == "meta":
        return torch.empty((B, N), dtype=out_dtype, device="meta")
    if x.device.type == "cpu":
        return ref.gemv_ref(x, w, out_dtype=out_dtype, w_layout=w_layout)
    if x.device.type != "cuda":
        raise ValueError(f"gemv kernel runs on cuda, not {x.device}")
    build.refuse_autograd(
        "gemv kernel", (x, w),
        "call core.gemm.balanced_gemm, whose backward launches the kernels")
    r = route(w, w_layout)
    _check(x, w, B=B, K=K, N=N, bk=bk, bn=bn, out_dtype=out_dtype, r=r)
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = _props(index)
    lp = launch_plan(B, K, N, bk, bn, x.dtype, w.dtype, w_layout, r,
                     props.multi_processor_count,
                     props.shared_memory_per_block_optin)
    out = torch.empty((B, N), dtype=out_dtype, device=dev)
    partial = tk = None
    if lp.splits > 1:
        partial = torch.empty((lp.splits, B, N), dtype=ref.acc_dtype(x.dtype),
                              device=dev)
        groups = 1 if r == TMA else -(-B // rows_per_group(B))
        tk = tickets(dev, -(-N // bn) * groups)
    vec = vec_elems(w.dtype)
    contiguous_len = K if w_layout == "col" else N
    vec_ok = contiguous_len % vec == 0 and \
        w.data_ptr() % (vec * w.element_size()) == 0
    x_vec = x.data_ptr() % 16 == 0 and (K * x.element_size()) % 16 == 0
    err = _lib().repro_decode_matvec(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if tk is None else tk.data_ptr(),
        B, K, N, bk, bn, lp.splits, lp.k_per_split,
        DTYPE_CODE[x.dtype], DTYPE_CODE[w.dtype], DTYPE_CODE[out_dtype],
        int(w_layout == "col"), ROUTE_CODE[r], int(vec_ok), lp.rt, lp.cpt,
        lp.stage_k, lp.stages, int(x_vec), lp.mt,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"repro_decode_matvec ({r})")
    launches += 1
    return out
