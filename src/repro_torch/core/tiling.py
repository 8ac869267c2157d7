"""Multi-level tiling descriptor — the paper's Fig. 3a (port of
``repro.core.tiling``).

  level 1  intrinsic  — the native instruction tile; the paper's r×s×t
  level 2  block      — the fast-memory-resident (bm, bk, bn); the paper's
                        m_ct×k_ct×n_ct
  level 3  grid       — how the blocks run over the problem
  level 4  problem    — the full M×K×N

Under a TPU spec (``hw`` None or a TPU generation) every level is the
reference's: the MXU intrinsic (sublane per dtype, 128 lanes), the VMEM
working set of Eq. 5, and the per-core sequential grid. Under a GPU spec
they describe ``csrc/matmul.cu`` on the GEMM's route
(``kernels/matmul.py``):

* intrinsic: wgmma m64n128k16 (bf16) or m64n128k32 (int8) on the
  tensor-core routes; on the CUDA-core routes the granularity the kernel
  tiles in: 8 rows a split-K block, a 16 x 16 thread grid, K in
  ``BK_STEP``;
* working set: the block's dynamic shared memory (``smem_bytes``);
* grid: the blocks of one launch, (row blocks, column blocks, K splits),
  counted in waves over the card's SMs (``waves``), since the blocks run
  side by side, not in order.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import perfmodel as pm
from repro_torch.core.hwregistry import get_hw
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels.ops import GemmPlan

_INTRINSIC = {
    _mm.TENSOR_CORE: (64, 16, 128),
    _mm.TENSOR_CORE_INT8: (64, 32, 128),
    _mm.SPLIT_K: (8, _mm.BK_STEP, 64),
    _mm.CUDA_CORE: (16, _mm.BK_STEP, 16),
}


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Fully-resolved multi-level tiling of one GEMM."""

    M: int
    K: int
    N: int
    plan: GemmPlan
    in_dtype: str = "bfloat16"
    out_dtype: str = "bfloat16"
    m_rows: int = 1   # spatial parallelism over M (mesh 'data' extent)
    n_cols: int = 1   # spatial parallelism over N (mesh 'model' extent)
    hw: str | None = None    # None: the reference's TPU description
    b_layout: str = "row"

    @property
    def _spec(self) -> pm.HardwareSpec | None:
        if self.hw is None:
            return None
        spec = get_hw(self.hw)
        return spec if spec.kind == "gpu" else None

    @property
    def route(self) -> str | None:
        """The GPU kernel route (None on a TPU)."""
        spec = self._spec
        return None if spec is None else spec.gemm_route(
            self.M, self.in_dtype, self.b_layout)

    # ---- level 1: intrinsic
    @property
    def intrinsic(self) -> tuple[int, int, int]:
        r = self.route
        if r is not None:
            return _INTRINSIC[r]
        sub = pm.SUBLANE[pm.itemsize(self.in_dtype)]
        return (sub, pm.LANE, pm.LANE)

    # ---- level 2: block
    @property
    def block(self) -> tuple[int, int, int]:
        return (self.plan.bm, self.plan.bk, self.plan.bn)

    def vmem_working_set(self) -> int:
        """Fast-memory bytes of one block: Eq. 5's VMEM on a TPU, the
        route's dynamic shared memory on a GPU."""
        r = self.route
        if r is not None:
            return _mm.smem_bytes(r, *self.block)
        return pm.vmem_bytes(*self.block, pm.itemsize(self.in_dtype),
                             pm.itemsize(self.out_dtype))

    # ---- level 3: array / grid
    @property
    def native_size(self) -> tuple[int, int, int]:
        """The paper's native GEMM size: (m_ct·m_rows) × k_mt × (n_ct·n_cols)."""
        return (
            self.plan.bm * self.m_rows,
            self.plan.bk,
            self.plan.bn * self.n_cols,
        )

    @property
    def padded(self) -> tuple[int, int, int]:
        nm, nk, nn = self.native_size
        r = lambda x, b: -(-x // b) * b
        return r(self.M, nm), r(self.K, nk), r(self.N, nn)

    @property
    def grid(self) -> tuple[int, int, int]:
        """TPU: the per-device sequential grid (i, j, k), the pallas_call
        grid. GPU: the blocks of one launch (row blocks, column blocks, K
        splits); a block loops over its K range itself."""
        spec = self._spec
        if spec is None:
            Mp, Kp, Np = self.padded
            return (
                Mp // (self.plan.bm * self.m_rows),
                Np // (self.plan.bn * self.n_cols),
                Kp // self.plan.bk,
            )
        bm, bk, bn = self.block
        if self.route == _mm.SPLIT_K:
            splits, _ = _mm.split_k(self.M, self.K, self.N, bk, bn,
                                    spec.sm_count)
            return (-(-self.M // _mm.rows_per_group(self.M)),
                    -(-self.N // bn), splits)
        return (-(-self.M // bm), -(-self.N // bn), 1)

    @property
    def waves(self) -> int:
        """GPU: rounds of one block an SM the grid takes (1 on a TPU, whose
        grid is one sequence)."""
        spec = self._spec
        if spec is None:
            return 1
        i, j, k = self.grid
        return -(-(i * j * k) // spec.sm_count)

    @property
    def padding_waste(self) -> float:
        """Fraction of padded FLOPs that are zero-padding overhead (on a GPU
        the masked edge of a ragged tile)."""
        Mp, Kp, Np = self.padded
        return 1.0 - (self.M * self.K * self.N) / (Mp * Kp * Np)

    def validate(self) -> "TileConfig":
        r, s, t = self.intrinsic
        bm, bk, bn = self.block
        if bm % r or bk % s or bn % t:
            raise ValueError(
                f"block {self.block} not aligned to intrinsic {self.intrinsic}"
            )
        return self
