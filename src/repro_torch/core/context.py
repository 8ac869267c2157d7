"""GemmContext — the execution state every GEMM reads (port of
``repro.core.context``).

* ``hw``         — the :class:`HardwareSpec` the planner solves for
                   (:mod:`repro_torch.core.hwregistry`, default ``h100``);
* ``quant_mode`` — None (full precision) or ``"int8"``: every ``dense()``
                   with a float weight takes the dynamic W8A8 path
                   (``layers.quantized.dynamic_qdense``);
* ``plan_cache`` — the :class:`PlanCache` serving solved GEMM plans;
* ``mesh``       — the :class:`repro_torch.launch.mesh.Mesh` a sharded step
                   runs over (None: one device), as the reference's
                   ``set_activation_mesh`` records it;
* ``shard``      — the sharded step's :class:`repro_torch.parallel.fsdp.
                   ShardPlan`: the models gather each stacked layer slice
                   through it just before use (None: nothing to gather);
* ``collectives``— a :class:`repro_torch.core.distributed.CollectiveCounter`
                   that the port's collective helpers add their bytes to.

The last three ride the context so that autograd's device thread, which
the context variable does not reach, gets them back wherever the GEMM
context is re-installed (``core.gemm._BalancedGemm``,
``core.gemm.checkpointed``, ``parallel.fsdp.Gather``).

There is no kernel-backend field: the device of the tensors decides (CUDA
launches the hand-written kernels, CPU runs their plain versions).
``current_context()`` returns the process default until a ``use_context``
block installs an override; blocks nest and restore on exit (contextvar
semantics).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

from repro_torch.core import hwregistry
from repro_torch.core.perfmodel import HardwareSpec
from repro_torch.core.plancache import PlanCache

QUANT_MODES = (None, "int8")

_UNSET = object()


@dataclasses.dataclass
class GemmContext:
    """Execution context; swap whole contexts with ``use_context``."""

    hw: HardwareSpec
    quant_mode: str | None = None
    plan_cache: PlanCache = dataclasses.field(default_factory=PlanCache)
    mesh: Any = None
    shard: Any = None
    collectives: Any = None

    def __post_init__(self):
        self.hw = hwregistry.get_hw(self.hw)
        if self.quant_mode == "none":
            self.quant_mode = None
        if self.quant_mode not in QUANT_MODES:
            raise ValueError(f"quant mode must be one of {QUANT_MODES} or "
                             f"'none', got {self.quant_mode!r}")


_DEFAULT: GemmContext | None = None
_CTX: contextvars.ContextVar[GemmContext | None] = contextvars.ContextVar(
    "repro_torch_gemm_context", default=None)


def current_context() -> GemmContext:
    ctx = _CTX.get()
    if ctx is not None:
        return ctx
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = GemmContext(hw=hwregistry.default_hw())
    return _DEFAULT


def resolve_hw(hw: str | HardwareSpec | None) -> HardwareSpec:
    """The hw-default rule: explicit arg > active context."""
    if hw is None:
        return current_context().hw
    return hwregistry.get_hw(hw)


def expect_steady_state(what: str = "steady-state region"):
    """Assert zero lazy plan solves and zero misses on the active
    context's plan cache for the extent of the block
    (:meth:`PlanCache.expect_steady_state`)."""
    return current_context().plan_cache.expect_steady_state(what)


@contextlib.contextmanager
def use_context(
    ctx: GemmContext | None = None,
    *,
    hw: str | HardwareSpec | None = None,
    quant_mode: str | None = _UNSET,
    plan_cache: PlanCache | None = None,
    mesh: Any = _UNSET,
    shard: Any = _UNSET,
    collectives: Any = _UNSET,
):
    """Install a context for the dynamic extent of the block.

    With no ``ctx``, derives a copy of the current context with the given
    overrides applied.
    """
    if ctx is None:
        base = current_context()
        ctx = GemmContext(
            hw=hwregistry.get_hw(hw) if hw is not None else base.hw,
            quant_mode=(base.quant_mode if quant_mode is _UNSET
                        else quant_mode),
            plan_cache=plan_cache if plan_cache is not None
            else base.plan_cache,
            mesh=base.mesh if mesh is _UNSET else mesh,
            shard=base.shard if shard is _UNSET else shard,
            collectives=(base.collectives if collectives is _UNSET
                         else collectives),
        )
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)
