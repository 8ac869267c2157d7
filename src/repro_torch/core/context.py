"""GemmContext — the execution state every GEMM reads (port of
``repro.core.context``).

* ``hw``         — the :class:`HardwareSpec` the planner solves for
                   (:mod:`repro_torch.core.hwregistry`, default ``h100``);
* ``quant_mode`` — only None in this port so far (int8 is a later item);
* ``plan_cache`` — the :class:`PlanCache` serving solved GEMM plans.

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

from repro_torch.core import hwregistry
from repro_torch.core.perfmodel import HardwareSpec
from repro_torch.core.plancache import PlanCache

QUANT_MODES = (None,)

_UNSET = object()


@dataclasses.dataclass
class GemmContext:
    """Execution context; swap whole contexts with ``use_context``."""

    hw: HardwareSpec
    quant_mode: str | None = None
    plan_cache: PlanCache = dataclasses.field(default_factory=PlanCache)

    def __post_init__(self):
        self.hw = hwregistry.get_hw(self.hw)
        if self.quant_mode == "none":
            self.quant_mode = None
        if self.quant_mode not in QUANT_MODES:
            raise NotImplementedError(
                f"quant mode {self.quant_mode!r} is not ported yet "
                "(ROADMAP queue 1, item 6: int8)")


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


@contextlib.contextmanager
def use_context(
    ctx: GemmContext | None = None,
    *,
    hw: str | HardwareSpec | None = None,
    quant_mode: str | None = _UNSET,
    plan_cache: PlanCache | None = None,
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
        )
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)
