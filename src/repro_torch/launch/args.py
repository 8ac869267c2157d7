"""Shared launcher arguments (port of ``repro.launch.args``'s context
layer): ``--hw``, ``--plan-cache``, ``--device`` and ``--quantize``.

``--hw`` defaults to ``$REPRO_TORCH_HW``, else ``h100``; ``--plan-cache ''``
keeps plans in memory only; ``--device`` defaults to ``cuda`` (there is no
fallback to the CPU: ``--device cpu`` asks for the plain path).
"""
from __future__ import annotations

import argparse

from repro_torch.core.context import GemmContext
from repro_torch.core.hwregistry import default_hw, list_hw
from repro_torch.core.plancache import PlanCache, default_cache_path


def add_context_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    g = ap.add_argument_group("execution context")
    g.add_argument(
        "--hw", default=None, metavar="GEN",
        help=f"hardware generation for the GEMM planner/perf model "
             f"({', '.join(list_hw())}; default: $REPRO_TORCH_HW or h100)")
    g.add_argument(
        "--quantize", default="none", choices=["none"],
        help="weight quantization (int8 is not ported yet)")
    g.add_argument(
        "--plan-cache", default=None, metavar="PATH",
        help="persistent GEMM plan cache JSON (default: "
             "$REPRO_TORCH_PLAN_CACHE or ~/.cache/repro_torch/plancache.json;"
             " '' = in-memory only)")
    g.add_argument(
        "--device", default=None, metavar="DEV",
        help="torch device (default: cuda; 'cpu' runs the kernels' plain "
             "versions)")
    return ap


def context_from_args(args: argparse.Namespace) -> GemmContext:
    """Build (and load) the execution context an argparse namespace asks for."""
    path = args.plan_cache
    if path is None:
        path = default_cache_path()
    cache = PlanCache(path=path or None)
    cache.load()
    return GemmContext(
        hw=args.hw if args.hw is not None else default_hw(),
        quant_mode=args.quantize,
        plan_cache=cache,
    )
