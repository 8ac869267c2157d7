"""Skinny decode GEMM (GEMV): wrapper of the CUDA kernel
``csrc/decode_matvec.cu`` (counterpart of the Pallas kernel
``repro.kernels.decode_matvec.decode_matvec``).

``out[B,N] = x[B,K] @ W`` with B <= 128, W (K,N) row or (N,K) col, no
epilogue. On a CUDA tensor it launches the kernel, which streams W once and
masks ragged edges (W is never padded or copied); on a CPU tensor it runs
the plain version (``ref.gemv_ref``); on a meta tensor it returns the
output's shape only. ``launches`` counts kernel launches and nothing else.

Split-K: the (bk, bn) blocks come from the planner. When ceil(N/bn) column
blocks would leave most SMs idle (N = 2560 at bn = 128 gives 20 blocks on
132 SMs), K is split across grid rows, each split writes an f32/i32 partial
into scratch this wrapper allocates, and a second small kernel sums the
splits in a fixed order, so the result does not depend on scheduling.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.matmul import (  # noqa: F401 (re-exported)
    BK_STEP, BLOCKS_PER_SM, DTYPE_CODE, IN_TYPES, rows_per_group, split_k)

MAX_ROWS = 128
THREADS = 256

launches = 0


def vec_elems(w_dtype: torch.dtype) -> int:
    """W elements per vector load: 16 bytes (8 bytes for int8)."""
    return 8 if w_dtype == torch.int8 else 16 // w_dtype.itemsize


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_matvec")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_decode_matvec.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                        i, i, i, p]
    lib.repro_decode_matvec.restype = i
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, w, *, B, K, N, bk, bn, out_dtype) -> None:
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
    vec = vec_elems(w.dtype)
    lanes = bn // vec  # column lanes of one block (row layout)
    if bk <= 0 or bk % BK_STEP or bn % vec or lanes == 0 or THREADS % lanes:
        raise ValueError(f"no gemv kernel for bk={bk}, bn={bn} with {w.dtype}"
                         f" W: bk a multiple of {BK_STEP}, bn/{vec} dividing "
                         f"{THREADS}")
    if max(B * K, K * N) >= 2**31:
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
    _check(x, w, B=B, K=K, N=N, bk=bk, bn=bn, out_dtype=out_dtype)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    splits, k_per_split = split_k(B, K, N, bk, bn, _sm_count(index))
    out = torch.empty((B, N), dtype=out_dtype, device=x.device)
    partial = None
    if splits > 1:
        partial = torch.empty((splits, B, N), dtype=ref.acc_dtype(x.dtype),
                              device=x.device)
    vec = vec_elems(w.dtype)
    contiguous_len = K if w_layout == "col" else N
    vec_ok = contiguous_len % vec == 0 and \
        w.data_ptr() % (vec * w.element_size()) == 0
    err = _lib().repro_decode_matvec(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        B, K, N, bk, bn, splits, k_per_split,
        DTYPE_CODE[x.dtype], DTYPE_CODE[w.dtype], DTYPE_CODE[out_dtype],
        int(w_layout == "col"), int(vec_ok),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "repro_decode_matvec")
    launches += 1
    return out
