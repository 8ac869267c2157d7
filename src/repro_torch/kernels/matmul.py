"""Fat GEMM with the fused epilogue: wrapper of the CUDA kernel
``csrc/matmul.cu`` (counterpart of the Pallas kernel
``repro.kernels.matmul.matmul``).

``matmul`` takes the reference's arguments. On a CUDA tensor it launches the
hand-written kernel, which masks ragged M, N and K edges itself, so nothing
is padded or copied; on a CPU tensor it runs the plain version
(``ref.matmul_ref``); on a meta tensor it only returns the output's shape
(the plan warm-up traces the model there). ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# (bm, bn) output tiles the kernel is instantiated for (csrc/matmul.cu,
# REPRO_TILE): a 16 x 16 thread grid, at most 64 accumulators a thread.
TILES = ((16, 64), (16, 128), (32, 64), (32, 128),
         (64, 64), (64, 128), (128, 64), (128, 128))
BK_STEP = 32  # bk is any positive multiple of this

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.int16: 3, torch.int32: 4}
ACT_CODE = {None: 0, "none": 0, "relu": 1, "relu2": 2, "gelu": 3, "silu": 4}
IN_TYPES = ((torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
            (torch.int8, torch.int8))

launches = 0


def smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Dynamic shared memory of one block: the A and B slices of one bk
    step, staged in the 4-byte accumulator type, rows padded by one."""
    return bk * ((bm + 1) + (bn + 1)) * 4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                                 i, p]
    lib.repro_matmul.restype = i
    return lib


@functools.cache
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _check(a, b, bias, out_scale, *, M, K, N, bm, bk, bn, out_dtype,
           activation) -> None:
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
    if (bm, bn) not in TILES or bk <= 0 or bk % BK_STEP:
        raise ValueError(f"no kernel for tile (bm={bm}, bk={bk}, bn={bn}): "
                         f"(bm, bn) in {TILES}, bk a multiple of {BK_STEP}")
    if max(M * K, K * N, M * N) >= 2**31 or -(-M // bm) > 65535:
        raise ValueError(f"GEMM ({M}, {K}, {N}) exceeds the kernel's "
                         "32-bit index and grid limits")
    need = smem_bytes(bm, bk, bn)
    have = _smem_optin(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    if need > have:
        raise ValueError(f"tile ({bm}, {bk}, {bn}) needs {need} bytes of "
                         f"shared memory, the device allows {have}")


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
    the plan's; M, K and N need not be multiples of them.
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
    _check(a, b, bias, out_scale, M=M, K=K, N=N, bm=bm, bk=bk, bn=bn,
           out_dtype=out_dtype, activation=activation)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    err = _lib().repro_matmul(
        a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if out_scale is None else out_scale.data_ptr(),
        out.data_ptr(), M, K, N, bm, bk, bn,
        DTYPE_CODE[a.dtype], DTYPE_CODE[b.dtype], DTYPE_CODE[out_dtype],
        int(b_layout == "col"), ACT_CODE[activation],
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "repro_matmul")
    launches += 1
    return out
