"""RWKV-6 WKV recurrence, chunk-parallel: wrapper of the CUDA kernel
``csrc/wkv.cu`` (counterpart of the Pallas kernel ``repro.kernels.wkv.wkv``).

``wkv`` takes the reference kernel's arguments: r, k, v and wlog (the log
of the decay) as (BH, T, N), u as (BH, N) rows, the state as (BH, N, N),
and returns (y (BH, T, N), new state (BH, N, N) f32); T must be a multiple
of ``CHUNK``. On a CUDA tensor it launches the kernel (one block per row
of BH, the (N, N) state held in shared memory across all chunks); on a CPU
tensor it runs the plain version, :func:`wkv_ref`; on a meta tensor it
returns the outputs' shapes only. ``launches`` counts kernel launches and
nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

CHUNK = 32

launches = 0


def smem_bytes(N: int) -> int:
    """Dynamic shared memory of one block (csrc/wkv.cu): six (CHUNK, N+1)
    f32 chunk tiles, the (N, N) state, the (CHUNK, CHUNK) intra-chunk
    matrix, the bonus diagonal and the chunk-end log decays."""
    return 4 * (6 * CHUNK * (N + 1) + N * N + CHUNK * CHUNK + CHUNK + N)


def wkv_ref(r, k, v, wlog, u, state):
    """The plain version: ``layers.rwkv.wkv_chunk_parallel`` on the
    (BH, T, N) layout (one batch row of BH heads, u one row per head)."""
    from repro_torch.layers.rwkv import wkv_chunk_parallel

    BH, T, N = r.shape
    one = lambda t: t.reshape(1, BH, *t.shape[1:])
    y, s = wkv_chunk_parallel(one(r), one(k), one(v), one(wlog), u,
                              one(state), chunk=CHUNK)
    return y.reshape(BH, T, N), s.reshape(BH, N, N)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("wkv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_wkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    lib.repro_wkv.restype = i
    return lib


@functools.cache
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _check(r, k, v, wlog, u, state, *, BH, T, N) -> None:
    for name, t, shape in (("k", k, (BH, T, N)), ("v", v, (BH, T, N)),
                           ("wlog", wlog, (BH, T, N)), ("u", u, (BH, N)),
                           ("state", state, (BH, N, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    for name, t in (("r", r), ("k", k), ("v", v), ("wlog", wlog), ("u", u),
                    ("state", state)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"wkv kernel takes contiguous float32 {name}, "
                             f"got {t.dtype}")
    if BH == 0 or N == 0:
        raise ValueError(f"wkv kernel: empty (BH, N) = ({BH}, {N})")
    need = smem_bytes(N)
    have = _smem_optin(r.device.index if r.device.index is not None
                       else torch.cuda.current_device())
    if need > have:
        raise ValueError(f"wkv kernel at N={N} needs {need} bytes of shared "
                         f"memory, the device allows {have}")


def wkv(r, k, v, wlog, u, state):
    """r/k/v/wlog: (BH, T, N); u: (BH, N) broadcast rows; state (BH, N, N).

    Returns (y (BH, T, N), new_state). T must be a multiple of CHUNK.
    """
    global launches
    BH, T, N = r.shape
    if T % CHUNK:
        raise ValueError(f"T={T} must be a multiple of {CHUNK}")
    if r.device.type == "meta":
        return (torch.empty((BH, T, N), dtype=r.dtype, device="meta"),
                torch.empty((BH, N, N), dtype=torch.float32, device="meta"))
    if r.device.type == "cpu":
        return wkv_ref(r, k, v, wlog, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv kernel runs on cuda, not {r.device}")
    _check(r, k, v, wlog, u, state, BH=BH, T=T, N=N)
    y = torch.empty_like(r)
    s_out = torch.empty((BH, N, N), dtype=torch.float32, device=r.device)
    err = _lib().repro_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
        u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        BH, T, N, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "repro_wkv")
    launches += 1
    return y, s_out
