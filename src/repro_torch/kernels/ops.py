"""Planned entry points of the two GEMM kernels (port of
``repro.kernels.ops``).

* ``GemmPlan`` is the solved (bm, bk, bn) of one GEMM signature.
* ``_clamp_plan`` shrinks a plan for problems smaller than one block: under
  a TPU spec with the reference's alignment rules, under a GPU spec onto the
  tiles ``csrc/matmul.cu`` is built for on the GEMM's route.
* ``balanced_matmul`` / ``decode_matvec`` pick the blocks and call the
  kernel wrappers. On CPU tensors they keep the reference's zero-padding to
  the native GEMM size (§5.3.1) around the plain versions; on CUDA tensors
  the kernels mask ragged edges themselves, so no operand is padded or
  copied.

There is no backend switch: the tensors' device decides (CUDA launches the
kernel or raises, CPU runs the plain version).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_matvec as _mv
from repro_torch.kernels import matmul as _mm

# TPU alignment of the reference kernels: sublane multiple per itemsize on
# the second-to-last dim, 128-lane on the last.
SUBLANE = {4: 8, 2: 16, 1: 32}
LANE = 128


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A solved tiling plan: the paper's (m_ct, k_ct, n_ct) for one GEMM."""

    bm: int = 128
    bk: int = 512
    bn: int = 128

    def native_size(self, M: int, K: int, N: int) -> tuple[int, int, int]:
        """Smallest (M', K', N') multiples of the blocks covering (M, K, N)."""
        r = lambda x, b: -(-x // b) * b
        return r(M, self.bm), r(K, self.bk), r(N, self.bn)


def _resolve_hw(hw):
    # core.context imports the plan cache, which imports GemmPlan from here
    from repro_torch.core.context import resolve_hw

    return resolve_hw(hw)


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    pr, pc = rows - x.shape[0], cols - x.shape[1]
    if pr == 0 and pc == 0:
        return x
    return F.pad(x, (0, pc, 0, pr))


def _cover(x: int, options: list[int]) -> int:
    """Smallest option >= x, else the largest option."""
    return next((o for o in options if o >= x), options[-1])


def _fit(x: int, options: list[int]) -> int:
    """Largest option <= x, else the smallest option."""
    return max((o for o in options if o <= x), default=options[0])


def _clamp_plan(plan: GemmPlan, M: int, K: int, N: int, dtype,
                hw=None, b_layout: str = "row") -> GemmPlan:
    """Shrink blocks for problems smaller than one block."""
    hw = _resolve_hw(hw)
    if hw.kind == "gpu":
        r = _mm.plan_route(M, dtype, b_layout)
        bms = sorted({bm for bm, _ in _mm.TILES[r]})
        bns = sorted({bn for _, bn in _mm.TILES[r]})
        step = _mm.BK_STEP
        bk = _mm.TC_BK.get(r) or max(
            step, min(plan.bk, -(-K // step) * step) // step * step)
        return GemmPlan(bm=_fit(min(plan.bm, _cover(M, bms)), bms), bk=bk,
                        bn=_fit(min(plan.bn, _cover(N, bns)), bns))
    sub = SUBLANE[dtype.itemsize]
    al = lambda x, a: max(a, -(-min(x, a * (-(-x // a))) // a) * a)
    return GemmPlan(bm=min(plan.bm, al(M, sub)), bk=min(plan.bk, al(K, LANE)),
                    bn=min(plan.bn, al(N, LANE)))


def balanced_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    plan: GemmPlan | None = None,
    out_dtype: torch.dtype | None = None,
    b_layout: str = "row",
    activation: str | None = None,
    out_scale: torch.Tensor | None = None,
    hw=None,
) -> torch.Tensor:
    """General GEMM through the fat kernel with the fused epilogue.

    ``out_scale``: scalar or (N,) per-output-channel requantization
    multiplier; ``bias`` is added after it, in f32 (see kernels/matmul.py).
    """
    if out_dtype is None:
        out_dtype = a.dtype
    M, K = a.shape
    N = b.shape[0] if b_layout == "col" else b.shape[1]
    if out_scale is not None:
        if out_scale.ndim not in (0, 1) or (
                out_scale.ndim == 1 and out_scale.shape != (N,)):
            raise ValueError(f"out_scale must be scalar or (N,)=({N},), "
                             f"got {tuple(out_scale.shape)}")
        out_scale = out_scale.to(torch.float32).expand(N).contiguous()
    if bias is not None and bias.is_floating_point():
        bias = bias.to(torch.float32)
    plan = _clamp_plan(plan or GemmPlan(), M, K, N, a.dtype, hw,
                       b_layout)
    a = a.contiguous()
    if a.device.type != "cpu":
        return _mm.matmul(a, b, bias, out_scale, bm=plan.bm, bk=plan.bk,
                          bn=plan.bn, out_dtype=out_dtype, b_layout=b_layout,
                          activation=activation)
    Mp, Kp, Np = plan.native_size(M, K, N)
    ap = _pad2(a, Mp, Kp)
    bp = _pad2(b, Np, Kp) if b_layout == "col" else _pad2(b, Kp, Np)
    biasp = None if bias is None else F.pad(bias, (0, Np - N))
    # pad the scale with ones: padded channels are sliced off below, but a
    # zero scale would turn garbage into NaN under activations
    scalep = (None if out_scale is None
              else F.pad(out_scale, (0, Np - N), value=1.0))
    out = _mm.matmul(ap, bp, biasp, scalep, bm=plan.bm, bk=plan.bk,
                     bn=plan.bn, out_dtype=out_dtype, b_layout=b_layout,
                     activation=activation)
    return out[:M, :N]


def decode_matvec(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    bk: int = 1024,
    bn: int = 256,
    out_dtype: torch.dtype | None = None,
    w_layout: str = "row",
    hw=None,
) -> torch.Tensor:
    """Decode-step skinny GEMM; see decode_matvec.py."""
    if out_dtype is None:
        out_dtype = x.dtype
    B, K = x.shape
    N = w.shape[0] if w_layout == "col" else w.shape[1]
    x = x.contiguous()
    if _resolve_hw(hw).kind == "gpu":
        step = _mm.BK_STEP
        bk = min(bk, -(-K // step) * step)
        Bp = B
    else:
        bk = min(bk, -(-K // LANE) * LANE)
        bn = min(bn, -(-N // LANE) * LANE)
        Bp = -(-B // SUBLANE[x.dtype.itemsize]) * SUBLANE[x.dtype.itemsize]
    if x.device.type != "cpu":
        return _mv.decode_matvec(x, w, bk=bk, bn=bn, out_dtype=out_dtype,
                                 w_layout=w_layout)
    Kp, Np = -(-K // bk) * bk, -(-N // bn) * bn
    xp = _pad2(x, Bp, Kp)
    wp = _pad2(w, Np, Kp) if w_layout == "col" else _pad2(w, Kp, Np)
    out = _mv.decode_matvec(xp, wp, bk=bk, bn=bn, out_dtype=out_dtype,
                            w_layout=w_layout)
    return out[:B, :N]
