"""Balanced-point tile optimization (port of ``repro.core.balance``:
``solve_exhaustive`` and the types it returns).

What the solver may choose is a property of the hardware: the candidate
tiles and the working-set model come from ``HardwareSpec.candidate_blocks``
and ``HardwareSpec.working_set``. Under a TPU spec they are exactly the
reference's (``balance.candidate_blocks`` and the VMEM model of
``kernels/matmul.vmem_bytes``), so the plans agree one for one; under
``h100`` they are the tiles ``csrc/matmul.cu`` is built for on the GEMM's
route (``HardwareSpec.gemm_route``) and that route's shared memory.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import perfmodel as pm
from repro_torch.core.context import resolve_hw
from repro_torch.kernels.ops import GemmPlan


@dataclasses.dataclass(frozen=True)
class BalanceStep:
    """One evaluated plan with its modeled times."""

    plan: GemmPlan
    t_comp: float
    t_mem: float
    t_total: float
    tops: float


@dataclasses.dataclass(frozen=True)
class BalanceResult:
    plan: GemmPlan
    steps: list[BalanceStep]
    tops: float

    @property
    def chosen_step(self) -> BalanceStep | None:
        """The recorded step the returned plan came from."""
        for s in self.steps:
            if s.plan == self.plan:
                return s
        return None


def solve_exhaustive(
    M: int, K: int, N: int,
    *,
    hw: pm.HardwareSpec | str | None = None,
    in_dtype=torch.bfloat16,
    out_dtype=None,
    b_layout: str = "row",
) -> BalanceResult:
    """Evaluate the modeled end-to-end time of every feasible tile and keep
    the fastest (ties go to the first in sweep order, as in the reference).
    """
    hw = resolve_hw(hw)
    if out_dtype is None:
        out_dtype = in_dtype
    ty_in = pm.itemsize(in_dtype)
    ty_out = pm.itemsize(out_dtype)
    budget = hw.vmem_bytes
    route = hw.gemm_route(M, in_dtype, b_layout)
    bms, bks, bns = hw.candidate_blocks(ty_in, route)
    best: BalanceStep | None = None
    for bm in bms:
        for bn in bns:
            for bk in bks:
                if hw.working_set(bm, bk, bn, ty_in, ty_out, route) > budget:
                    break  # bk ascending: larger only grows the working set
                est = pm.estimate_gemm(
                    hw, M, K, N, bm, bk, bn, in_dtype=in_dtype,
                    out_dtype=out_dtype, b_layout=b_layout)
                if best is None or est.t_total < best.t_total:
                    best = BalanceStep(
                        plan=GemmPlan(bm=bm, bk=bk, bn=bn),
                        t_comp=est.t_comp, t_mem=est.t_mem,
                        t_total=est.t_total,
                        tops=2.0 * M * K * N / est.t_total / 1e12,
                    )
    if best is None:
        raise ValueError(f"no tile of {hw.name} fits the {budget}-byte "
                         "working-set budget")
    return BalanceResult(plan=best.plan, steps=[best], tops=best.tops)
