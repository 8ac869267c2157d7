"""RWKV-6 WKV recurrence, chunk-parallel: wrappers of the CUDA kernel
``csrc/wkv.cu`` (counterpart of the Pallas kernel ``repro.kernels.wkv.wkv``).

Two wrappers launch the same kernel, which reads its inputs in place
through their (b, h, t) strides:

* ``wkv`` takes the reference kernel's arguments: r, k, v and wlog (the
  log of the decay) as (BH, T, N) f32, u as (BH, N) rows, the state as
  (BH, N, N), and returns (y (BH, T, N), new state (BH, N, N) f32);
* ``wkv_heads`` takes what ``layers.rwkv.time_mix`` holds: r, k, v as
  (B, T, H, N) in the activation dtype (f32 or bf16), the log decay
  (B, T, H, N) f32, u (H, N), the state (B, H, N, N), and returns
  (y (B, T, H, N) f32, new state (B, H, N, N)), with no layout copy.

T must be a multiple of ``CHUNK``. On a CUDA tensor a wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version, :func:`wkv_ref`
(``wkv_heads`` through ``wkv`` on the (BH, T, N) f32 copies, the
arithmetic of the plain path); on a meta tensor it returns the outputs'
shapes only. ``launches`` counts kernel launches and nothing else.

A block owns (b, h, a slice of ``ms`` value columns): :func:`partition`
picks ``ms`` and the grid, :func:`route` the load route, both before the
launch; :func:`wkv_msplit_ref` is the slice-by-slice algebra in plain
torch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

CHUNK = 32
THREADS = 256              # a block (csrc/wkv.cu)
HEAD_SIZES = (16, 32, 64, 128)
SLICES = (32, 16)          # value columns a block may own (ms)
SMEM_PER_SM = 233_472      # H100: 228 KB of shared memory an SM
SMEM_RESERVED = 1_024      # the system's share of it, per resident block
MAX_BLOCKS_PER_SM = 2_048 // THREADS

VECTOR, SCALAR = "vector", "scalar"

launches = 0


def smem_bytes(N: int, ms: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (csrc/wkv.cu Layout): the staging
    area (r and k in their ``itemsize`` with rows padded by 16 bytes, wl
    f32 with rows padded to N + 4, the v slice), the four decay-scaled f32
    tiles (one padded to N + 4), the v slice in f32, the (N, ms) state
    slice, the (C, C) matrix A, the bonus diagonal and its 8 partials, and
    three (N,) vectors."""
    C = CHUNK
    words = (2 * C * (N * itemsize + 16) // 4 + C * (N + 4)
             + C * ms * itemsize // 4 + 3 * N * C + C * (N + 4) + C * ms
             + N * ms + C * C + (THREADS // 32) * C + C + 3 * N)
    return 4 * words


def blocks_per_sm(N: int, ms: int, itemsize: int,
                  smem_per_sm: int = SMEM_PER_SM) -> int:
    """Blocks an SM holds at once, by shared memory and threads."""
    by_smem = smem_per_sm // (smem_bytes(N, ms, itemsize) + SMEM_RESERVED)
    return min(by_smem, MAX_BLOCKS_PER_SM)


class Partition(NamedTuple):
    ms: int          # value columns a block owns
    slices: int      # N // ms blocks a (b, h) row
    blocks: int      # the grid
    per_sm: int      # blocks the busiest SM runs
    resident: int    # blocks an SM holds at once


def _block_cost(N: int, ms: int) -> int:
    """Warp instructions one block issues a chunk (csrc/wkv.cu's roles):
    the decay-scaled tiles (4 exponentials an element, ~10 instructions
    each), A (2 warps, 18 instructions a step of N), y (2 ms / 32 warps,
    N + C steps) and S' (its warps, C steps of SN / 4 + 1 loads and 4 SN
    FMAs). The tiles and A are the same for every slice: a narrower slice
    recomputes them more often, but issues fewer of y's and S''s steps."""
    C = CHUNK
    sn = max(1, N * ms // 512)
    s_warps = -(-(ms // 4) * (N // sn) // 32)
    return (C * N * 40 // 32 + 2 * N * 18 + -(-2 * ms // 32) * (N + C) * 18
            + s_warps * C * (4 * sn + -(-sn // 4) + 1))


def partition(BH: int, N: int, sm_count: int, itemsize: int = 2,
              smem_per_sm: int = SMEM_PER_SM) -> Partition:
    """The slice width ``ms`` of least modeled time: the blocks of the
    busiest SM share its issue slots, so that time is ceil(blocks /
    sm_count) blocks' work. 160 or 40 rows of N = 64 take ms = 32 (the
    faster on an H100 at both, PERF.md); two rows of N = 128 take ms = 16,
    where one block an SM sets the pace."""
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv kernel takes N in {HEAD_SIZES}, got {N}")
    best = None
    for ms in SLICES:
        if ms > N:
            continue
        resident = blocks_per_sm(N, ms, itemsize, smem_per_sm)
        if resident == 0:
            continue
        blocks = BH * (N // ms)
        per_sm = -(-blocks // sm_count)
        cost = per_sm * _block_cost(N, ms)
        if best is None or cost < best[0]:
            best = (cost, Partition(ms, N // ms, blocks, per_sm, resident))
    if best is None:
        raise ValueError(f"wkv kernel at N={N}: no slice fits "
                         f"{smem_per_sm} bytes of shared memory an SM")
    return best[1]


def route(layouts) -> str:
    """``VECTOR`` (16-byte cp.async) when every row of every staged input
    starts on a 16-byte boundary: each (data_ptr, strides, itemsize) in
    ``layouts`` has a 16-byte-aligned base and (b, h, t) strides whose
    bytes are multiples of 16; ``SCALAR`` (element loads) otherwise."""
    for ptr, strides, itemsize in layouts:
        if ptr % 16 or any((s * itemsize) % 16 for s in strides):
            return SCALAR
    return VECTOR


def wkv_ref(r, k, v, wlog, u, state):
    """The plain version: ``layers.rwkv.wkv_chunk_parallel`` on the
    (BH, T, N) layout (one batch row of BH heads, u one row per head)."""
    from repro_torch.layers.rwkv import wkv_chunk_parallel

    BH, T, N = r.shape
    one = lambda t: t.reshape(1, BH, *t.shape[1:])
    y, s = wkv_chunk_parallel(one(r), one(k), one(v), one(wlog), u,
                              one(state), chunk=CHUNK)
    return y.reshape(BH, T, N), s.reshape(BH, N, N)


def wkv_msplit_ref(r, k, v, wlog, u, state, ms: int):
    """The kernel's algebra in plain torch: every slice of ``ms`` value
    columns on its own, from the (BH, T, N) layout. Each slice recomputes
    the cumsum, the decay-scaled tiles, A and the bonus diagonal, and
    yields only its columns of y and of the new state."""
    BH, T, N = r.shape
    if T % CHUNK or N % ms:
        raise ValueError(f"T={T} must be a multiple of {CHUNK} and N={N} "
                         f"of ms={ms}")
    C = CHUNK
    causal = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                   device=r.device), -1)
    ys, states = [], []
    for m0 in range(0, N, ms):
        S = state[..., m0:m0 + ms].float()
        out = []
        for t0 in range(0, T, C):
            rc, kc, wl = (x[:, t0:t0 + C].float() for x in (r, k, wlog))
            vc = v[:, t0:t0 + C, m0:m0 + ms].float()
            cl = torch.cumsum(wl, dim=1) - wl
            ci = cl + wl
            ce = ci[:, -1:]
            mid = cl[:, C // 2:C // 2 + 1]
            re = rc * torch.exp(cl)
            rm = rc * torch.exp(cl - mid)
            ki = kc * torch.exp(torch.clamp(mid - ci, max=60.0))
            kd = kc * torch.exp(torch.clamp(ce - ci, max=0.0))
            A = torch.einsum("btn,bsn->bts", rm, ki) * causal
            diag = torch.sum(rc * u[:, None, :] * kc, dim=-1)
            out.append(torch.einsum("btn,bnm->btm", re, S)
                       + (torch.einsum("bts,bsm->btm", A, vc)
                          + diag[..., None] * vc))
            S = torch.exp(ce)[:, 0, :, None] * S + torch.einsum(
                "bsn,bsm->bnm", kd, vc)
        ys.append(torch.cat(out, dim=1))
        states.append(S)
    return torch.cat(ys, dim=-1), torch.cat(states, dim=-1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("wkv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_wkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                              p, p]
    lib.repro_wkv.restype = i
    return lib


@functools.cache
def _device_props(index: int):
    return torch.cuda.get_device_properties(index)


def _same_device(r, others) -> None:
    for name, t in others:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")


def _check_heads(r, k, v, log_w, u, state) -> tuple[int, int, int, int]:
    """Shapes, devices, dtypes and unit stride along N of ``wkv_heads``'s
    arguments, on every device; returns (B, T, H, N)."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, N), got {tuple(r.shape)}")
    B, T, H, N = r.shape
    if T % CHUNK:
        raise ValueError(f"T={T} must be a multiple of {CHUNK}")
    for name, t, shape in (("k", k, (B, T, H, N)), ("v", v, (B, T, H, N)),
                           ("log_w", log_w, (B, T, H, N)), ("u", u, (H, N)),
                           ("state", state, (B, H, N, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    _same_device(r, (("k", k), ("v", v), ("log_w", log_w), ("u", u),
                     ("state", state)))
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        if N > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride along N, got "
                             f"strides {t.stride()}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"r, k, v must share float32 or bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("log_w", log_w), ("u", u), ("state", state)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    return B, T, H, N


def _launch(r, k, v, wl, u, state, y, s_out, *, B, H, T, N, strides,
            ms) -> None:
    """One kernel launch; ``strides`` are the (b, h, t) element strides of
    r, k, v, wl and y. Picks the slice width (unless given) and the load
    route before the launch; raises on anything the kernel cannot take."""
    global launches
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv kernel takes N in {HEAD_SIZES}, got {N}")
    if B == 0 or H == 0:
        raise ValueError(f"wkv kernel: empty (B, H) = ({B}, {H})")
    if not (u.is_contiguous() and state.is_contiguous()):
        raise ValueError("wkv kernel takes contiguous u and state")
    props = _device_props(r.device.index if r.device.index is not None
                          else torch.cuda.current_device())
    isz = r.element_size()
    if ms is None:
        ms = partition(B * H, N, props.multi_processor_count, isz).ms
    if ms not in SLICES or ms > N:
        raise ValueError(f"wkv kernel: ms={ms} not in {SLICES} or above "
                         f"N={N}")
    need = smem_bytes(N, ms, isz)
    have = props.shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"wkv kernel at N={N}, ms={ms} needs {need} bytes "
                         f"of shared memory, the device allows {have}")
    vec = route([(t.data_ptr(), s, t.element_size())
                 for t, s in zip((r, k, v, wl), strides[:4])]) == VECTOR
    flat = (ctypes.c_longlong * 15)(*(x for s in strides for x in s))
    err = _lib().repro_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), wl.data_ptr(),
        u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        B, H, T, N, ms, int(r.dtype == torch.bfloat16), int(vec),
        ctypes.cast(flat, ctypes.c_void_p),
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "repro_wkv")
    launches += 1


def wkv(r, k, v, wlog, u, state, *, ms: int | None = None):
    """r/k/v/wlog: (BH, T, N) f32; u: (BH, N) broadcast rows; state
    (BH, N, N).

    Returns (y (BH, T, N), new_state). T must be a multiple of CHUNK.
    ``ms`` overrides the partition's slice width (for measurement).
    """
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
    for name, t, shape in (("k", k, (BH, T, N)), ("v", v, (BH, T, N)),
                           ("wlog", wlog, (BH, T, N)), ("u", u, (BH, N)),
                           ("state", state, (BH, N, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    _same_device(r, (("k", k), ("v", v), ("wlog", wlog), ("u", u),
                     ("state", state)))
    for name, t in (("r", r), ("k", k), ("v", v), ("wlog", wlog), ("u", u),
                    ("state", state)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"wkv kernel takes contiguous float32 {name}, "
                             f"got {t.dtype}")
    y = torch.empty_like(r)
    s_out = torch.empty((BH, N, N), dtype=torch.float32, device=r.device)
    # BH rows as H heads of one batch row: u is read as (H, N)
    bh = lambda t: (0, t.stride(0), t.stride(1))
    _launch(r, k, v, wlog, u, state, y, s_out, B=1, H=BH, T=T, N=N,
            strides=[bh(t) for t in (r, k, v, wlog, y)], ms=ms)
    return y, s_out


def wkv_heads(r, k, v, log_w, u, state, *, ms: int | None = None):
    """r/k/v: (B, T, H, N) f32 or bf16; log_w: (B, T, H, N) f32; u: (H, N);
    state (B, H, N, N) f32.

    Returns (y (B, T, H, N) f32, new_state (B, H, N, N)). T must be a
    multiple of CHUNK; every input needs unit stride along N. On a CUDA
    tensor the kernel reads the inputs where they lie and writes y in this
    layout: no copy. Elsewhere: ``wkv`` on the (B*H, T, N) f32 copies,
    transposed back (a view).
    """
    B, T, H, N = _check_heads(r, k, v, log_w, u, state)
    if r.device.type != "cuda":
        to_bh = lambda t: t.float().transpose(1, 2).reshape(B * H, T, N)
        y_bh, s = wkv(to_bh(r), to_bh(k), to_bh(v), to_bh(log_w),
                      u[None].expand(B, H, N).reshape(B * H, N),
                      state.reshape(B * H, N, N))
        return (y_bh.reshape(B, H, T, N).transpose(1, 2),
                s.reshape(B, H, N, N))
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    bth = lambda t: (t.stride(0), t.stride(2), t.stride(1))
    _launch(r, k, v, log_w, u, state, y, s_out, B=B, H=H, T=T, N=N,
            strides=[bth(t) for t in (r, k, v, log_w, y)], ms=ms)
    return y, s_out
