"""Analytical performance model — the paper's Eqs. 1–10 (port of
``repro.core.perfmodel``).

The formulas are the reference's, term for term, so a TPU spec solves to
exactly the reference's plans. What depends on the machine is a property of
the :class:`HardwareSpec`: the candidate tiles and the working-set model
(``candidate_blocks`` / ``working_set``, see ``core/balance.py``), the rate
the kernels compute at (``peak_flops``) and the bytes reckoned for B
(``b_itemsize``). For ``kind="gpu"`` those describe the routes of the
hand-written CUDA kernel ``csrc/matmul.cu`` (``kernels/matmul.py``): a GEMM's
route (``gemm_route``) sets its tiles, its shared memory and its rate. The
plan key carries only A's dtype, so a float B is reckoned at 4 bytes and as
the three bf16 passes of an f32 B on the tensor cores, its worst case.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.kernels import matmul as _mm

# Sublane alignment per dtype (second-to-last dim) and the lane width of the
# TPU kernels: the reference's constants, kept for the TPU specs.
SUBLANE = {4: 8, 2: 16, 1: 32}
LANE = 128


def itemsize(dtype) -> int:
    return torch_dtype(dtype).itemsize


def is_int_dtype(dtype) -> bool:
    dt = torch_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex)


def vmem_bytes(bm: int, bk: int, bn: int, ty_in: int, ty_out: int,
               acc_bytes: int = 4) -> int:
    """VMEM working set of one TPU grid step — the reference's Eq. 5."""
    return (2 * bm * bk * ty_in + 2 * bk * bn * ty_in
            + bm * bn * acc_bytes + bm * bn * ty_out)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip hardware constants."""

    name: str
    peak_flops_bf16: float  # FLOP/s (MAC = 2 FLOPs)
    peak_flops_int8: float  # OP/s
    hbm_bw: float           # B/s
    ici_bw: float           # B/s per link (NVLink, each way, on a GPU)
    vmem_bytes: int         # fast-memory budget of one block's working set
    vmem_bw: float          # B/s of that fast memory (accumulator traffic)
    hbm_latency_bytes: float  # contiguity knee of effective_bw (paper Fig. 6)
    mxu: int = 128          # native matrix-unit tile edge (TPU)
    peak_flops_f32: float = 0.0  # FLOP/s for f32 (0 -> bf16/2)
    kind: str = "tpu"       # "tpu" | "gpu"
    sm_count: int = 0       # streaming multiprocessors (GPU)

    def gemm_route(self, M: int, dtype, b_layout: str = "row"
                   ) -> str | None:
        """The GPU kernel route a plan of this GEMM is for (None on a TPU)."""
        if self.kind != "gpu":
            return None
        return _mm.plan_route(M, torch_dtype(dtype), b_layout)

    def peak_flops(self, dtype, route: str | None = None) -> float:
        """Rate the GEMM kernels compute at for inputs of ``dtype`` (on a
        GPU, on ``route``)."""
        if self.kind == "gpu":
            if route == _mm.TENSOR_CORE:
                # an f32 B (the worst case of a float B) takes three bf16
                # passes
                return self.peak_flops_bf16 / 3
            if route == _mm.TENSOR_CORE_INT8:
                return self.peak_flops_int8
            # CUDA cores: floats as f32 FMAs, int8 as i32 multiply-adds,
            # which Hopper issues at half the f32 rate (64 vs 128 lanes/SM)
            if is_int_dtype(dtype):
                return self.peak_flops_f32 / 2
            return self.peak_flops_f32
        return self.dense_peak(dtype)

    def dense_peak(self, dtype) -> float:
        """The data sheet's dense rate for ``dtype`` (on a GPU its tensor
        cores' bf16 or int8 rate, whatever route a kernel takes): the
        roofline's compute peak."""
        if is_int_dtype(dtype):
            return self.peak_flops_int8
        if torch_dtype(dtype) == torch.float32:
            return self.peak_flops_f32 or self.peak_flops_bf16 / 2
        return self.peak_flops_bf16

    def b_itemsize(self, ty_in: int) -> int:
        """Bytes reckoned per B element given A's itemsize: a GPU float B
        counts 4 bytes (the plan key records only A's dtype)."""
        if self.kind == "gpu" and ty_in != 1:
            return 4
        return ty_in

    def candidate_blocks(self, itemsize: int, route: str | None = None):
        """(bms, bks, bns) the solver may choose from (on a GPU, the tiles
        ``route`` is built for)."""
        if self.kind == "gpu":
            tiles = _mm.TILES[route]
            bms = sorted({bm for bm, _ in tiles})
            bns = sorted({bn for _, bn in tiles})
            bks = ([_mm.TC_BK[route]] if route in _mm.TC_BK
                   else list(range(_mm.BK_STEP, 1024 + 1, _mm.BK_STEP)))
            return bms, bks, bns
        sub = SUBLANE[itemsize]
        max_bk = 16384 // itemsize
        bms = sorted(set([sub, 2 * sub, 4 * sub, 64]
                         + list(range(128, 1024 + 1, 128))))
        bks = sorted(set(range(128, max_bk + 1, 128)))
        bns = sorted(set(range(128, 2048 + 1, 128)))
        return bms, bks, bns

    def working_set(self, bm: int, bk: int, bn: int, ty_in: int,
                    ty_out: int, route: str | None = None) -> int:
        """Bytes of fast memory one block needs (compared with vmem_bytes)."""
        if self.kind == "gpu":
            if (bm, bn) not in _mm.TILES[route] or not _mm.valid_bk(route, bk):
                return math.inf  # not a tile the route is built for
            return _mm.smem_bytes(route, bm, bk, bn)
        return vmem_bytes(bm, bk, bn, ty_in, ty_out)


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    peak_flops_int8=394e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    vmem_bytes=16 * 2**20,
    vmem_bw=11e12,
    hbm_latency_bytes=512.0,
    peak_flops_f32=98.5e12,
)


def effective_bw(hw: HardwareSpec, run_bytes: float) -> float:
    """Effective HBM bandwidth for reads of ``run_bytes``-long runs."""
    return hw.hbm_bw * (1.0 - math.exp(-run_bytes / hw.hbm_latency_bytes))


def mxu_efficiency(hw: HardwareSpec, bm: int, bk: int, bn: int,
                   itemsize: int) -> float:
    """Fraction of the matrix-unit peak one (bm, bk, bn) block attains
    (dimension-alignment derate). The GPU candidates are whole wgmma tiles
    or multiples of the CUDA-core kernel's 16 x 16 thread grid, so nothing
    is wasted there."""
    if hw.kind == "gpu":
        return 1.0

    def util(d: int, native: int) -> float:
        full = -(-d // native) * native
        return d / full

    sub = SUBLANE[itemsize]
    return util(bm, max(sub, hw.mxu)) * util(bk, hw.mxu) * util(bn, hw.mxu)


@dataclasses.dataclass(frozen=True)
class BlockTimes:
    """Per-block times (seconds) — the Eq. 1–3 analog."""

    t_comp: float
    t_a: float
    t_b: float
    t_acc: float

    @property
    def compute_bound(self) -> bool:  # Eq. 4
        return self.t_comp >= max(self.t_a, self.t_b)


def block_times(hw: HardwareSpec, bm: int, bk: int, bn: int, *,
                in_dtype=torch.bfloat16, b_layout: str = "row",
                route: str | None = None) -> BlockTimes:
    ty = itemsize(in_dtype)
    ty_b = hw.b_itemsize(ty)
    eff = mxu_efficiency(hw, bm, bk, bn, ty)
    t_comp = 2.0 * bm * bk * bn / (eff * hw.peak_flops(in_dtype, route))
    t_a = bm * bk * ty / effective_bw(hw, bk * ty)
    b_run = (bk if b_layout == "col" else bn) * ty_b
    t_b = bk * bn * ty_b / effective_bw(hw, b_run)
    t_acc = 2.0 * bm * bn * 4 / hw.vmem_bw
    return BlockTimes(t_comp=t_comp, t_a=t_a, t_b=t_b, t_acc=t_acc)


def kernel_efficiency(hw: HardwareSpec, bm: int, bk: int, bn: int, *,
                      in_dtype=torch.bfloat16, b_layout: str = "row",
                      route: str | None = None) -> float:
    """Modeled single-kernel efficiency: attained / peak."""
    bt = block_times(hw, bm, bk, bn, in_dtype=in_dtype, b_layout=b_layout,
                     route=route)
    step = max(bt.t_comp, bt.t_a, bt.t_b) + bt.t_acc
    return bt.t_comp * mxu_efficiency(hw, bm, bk, bn, itemsize(in_dtype)) / step


def dram_traffic(M: int, K: int, N: int, bm: int, bn: int, *, ty_in: int,
                 ty_out: int, ty_b: int, m_rows: int = 1, n_cols: int = 1
                 ) -> tuple[float, float, float]:
    """Eqs. 6–8: total HBM bytes for A reads, B reads, C writes. (m_rows,
    n_cols) generalize them to the mesh (``core.distributed``'s
    output-stationary mapping) exactly as in the paper; at one chip they
    are 1."""
    a_mem = M * K * N * ty_in / (bn * n_cols)
    b_mem = M * K * N * ty_b / (bm * m_rows)
    c_mem = M * N * ty_out
    return a_mem, b_mem, c_mem


@dataclasses.dataclass(frozen=True)
class GemmEstimate:
    t_comp: float
    t_mem: float
    eff: float
    a_mem: float
    b_mem: float
    c_mem: float

    @property
    def t_total(self) -> float:
        return max(self.t_comp, self.t_mem)


def grid_utilization(hw: HardwareSpec, M: int, N: int, bm: int,
                     bn: int, *, route: str | None = None, K: int = 0,
                     bk: int = 0) -> float:
    """GPU wave quantization: the (M/bm) x (N/bn) grid runs in waves of one
    block per SM, so a grid of 80 blocks keeps 80 of 132 SMs busy; the
    split-K route's grid is (N/bn) x row groups x K splits. 1.0 on a TPU,
    whose grid runs in order on one core."""
    if hw.kind != "gpu" or not hw.sm_count:
        return 1.0
    if route == _mm.SPLIT_K:
        splits, _ = _mm.split_k(M, K, N, bk, bn, hw.sm_count)
        blocks = -(-N // bn) * -(-M // _mm.rows_per_group(M)) * splits
    else:
        blocks = -(-M // bm) * -(-N // bn)
    waves = -(-blocks // hw.sm_count)
    return blocks / (waves * hw.sm_count)


def estimate_gemm(hw: HardwareSpec, M: int, K: int, N: int, bm: int, bk: int,
                  bn: int, *, in_dtype=torch.bfloat16, out_dtype=None,
                  b_layout: str = "row", m_rows: int = 1,
                  n_cols: int = 1) -> GemmEstimate:
    """End-to-end modeled GEMM time — Eqs. 9–10. ``m_rows`` / ``n_cols``
    extend the model to the mesh (paper §4.2): A is broadcast across
    ``m_rows`` and B across ``n_cols`` chips, each running its (M/m_rows,
    N/n_cols) block, so traffic and work divide as Eqs. 6–7 prescribe."""
    if out_dtype is None:
        out_dtype = in_dtype
    ty_in = itemsize(in_dtype)
    ty_out = itemsize(out_dtype)
    ty_b = hw.b_itemsize(ty_in)
    route = hw.gemm_route(M, in_dtype, b_layout)
    util = grid_utilization(hw, -(-M // m_rows), -(-N // n_cols), bm, bn,
                            route=route, K=K, bk=bk)
    r = lambda x, b: -(-x // b) * b
    M, K, N = r(M, bm * m_rows), r(K, bk), r(N, bn * n_cols)
    chips = m_rows * n_cols
    eff = kernel_efficiency(hw, bm, bk, bn, in_dtype=in_dtype,
                            b_layout=b_layout, route=route)
    t_comp = 2.0 * M * K * N / (eff * hw.peak_flops(in_dtype, route) * util
                                * chips)
    a_mem, b_mem, c_mem = dram_traffic(M, K, N, bm, bn, ty_in=ty_in,
                                       ty_out=ty_out, ty_b=ty_b,
                                       m_rows=m_rows, n_cols=n_cols)
    bw_a = effective_bw(hw, bk * ty_in)
    bw_b = effective_bw(hw, (bk if b_layout == "col" else bn) * ty_b)
    bw_c = effective_bw(hw, bn * ty_out)
    t_mem = (a_mem / bw_a + b_mem / bw_b + c_mem / bw_c) / chips
    return GemmEstimate(t_comp=t_comp, t_mem=t_mem, eff=eff,
                        a_mem=a_mem, b_mem=b_mem, c_mem=c_mem)


def gemm_tops(hw: HardwareSpec, M: int, K: int, N: int, bm: int, bk: int,
              bn: int, **kw) -> float:
    """Modeled achieved TOP/s of the whole GEMM (the paper's headline
    metric); ``kw`` as :func:`estimate_gemm`'s."""
    est = estimate_gemm(hw, M, K, N, bm, bk, bn, **kw)
    return 2.0 * M * K * N / est.t_total / 1e12


# ----------------------------------------------------------------- roofline
@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three dry-run roofline terms (seconds) for one step."""

    compute: float
    memory: float
    collective: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute, "memory": self.memory,
                 "collective": self.collective}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Step-time lower bound if all three streams fully overlap."""
        return max(self.compute, self.memory, self.collective)


def roofline_terms(hw: HardwareSpec, *, flops: float, hbm_bytes: float,
                   collective_bytes: float, chips: int,
                   dtype=torch.bfloat16) -> RooflineTerms:
    """FLOPs / (chips x dense peak), bytes / (chips x HBM rate),
    collective bytes / (chips x link rate). Per-device counts (the dry
    run's) take chips=1."""
    return RooflineTerms(
        compute=flops / (chips * hw.dense_peak(dtype)),
        memory=hbm_bytes / (chips * hw.hbm_bw),
        collective=collective_bytes / (chips * hw.ici_bw),
    )
