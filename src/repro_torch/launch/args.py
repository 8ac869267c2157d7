"""Shared launcher arguments (port of ``repro.launch.args``): the context
layer (``--hw``, ``--plan-cache``, ``--device``, ``--quantize``) and the
serving-engine layer (``--engine`` and what it honours).

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


def add_serve_engine_args(ap: argparse.ArgumentParser
                          ) -> argparse.ArgumentParser:
    """The serving-engine layer: only the flags this port honours. The
    reference's ``--kv-quantize`` (ROADMAP queue 1, item 6), ``--spec-*``
    (item 7) and tracer / registry / auditor flags (item 8) are not
    defined, so argparse rejects them."""
    g = ap.add_argument_group("serving engine")
    g.add_argument(
        "--engine", action="store_true",
        help="serve with the continuous-batching slot engine instead of "
             "static batching (repro_torch.serve)")
    g.add_argument(
        "--num-slots", type=int, default=4, metavar="N",
        help="fixed decode lanes: every decode tick is one (N, 1) step "
             "regardless of traffic (default 4)")
    g.add_argument(
        "--max-new-tokens", type=int, default=None, metavar="N",
        help="per-request generation budget for the engine trace "
             "(default: --gen)")
    g.add_argument(
        "--eos-id", type=int, default=None, metavar="ID",
        help="stop id: requests/sequences end early on this token "
             "(both engine and static paths)")
    g.add_argument(
        "--kv-block-size", type=int, default=0, metavar="B",
        help="paged KV: pool the engine cache in B-token blocks behind "
             "per-slot block tables (0 = contiguous per-slot regions); "
             "enables chunked prefill")
    g.add_argument(
        "--num-kv-blocks", type=int, default=None, metavar="N",
        help="paged KV pool size in blocks incl. the reserved null block "
             "(default: full num_slots*max_len capacity)")
    g.add_argument(
        "--prefill-chunk", type=int, default=None, metavar="C",
        help="chunked prefill: at most C prompt tokens a call, padded to "
             "one of the buckets {C/4, C/2, C} (paged engine only; "
             "default: the prompt pad)")
    g.add_argument(
        "--prefix-cache", action="store_true",
        help="share prompt-prefix KV across requests through a radix trie "
             "over the paged pool (needs --kv-block-size); serves a "
             "shared-header trace")
    g.add_argument(
        "--prefix-cache-blocks", type=int, default=None, metavar="N",
        help="cap the prefix cache at N pool blocks (default: unbounded)")
    g.add_argument(
        "--sched-policy", default="fifo",
        choices=["fifo", "priority", "edf", "prefix"],
        help="admission-ordering policy (serve/policy.py); priority/edf "
             "preempt lower-ranked decodes (paged engine only)")
    g.add_argument(
        "--ttft-target-ms", type=float, default=None, metavar="MS",
        help="TTFT target of the prefill budget controller (default: off, "
             "one chunk a tick)")
    g.add_argument(
        "--max-prefill-chunks", type=int, default=4, metavar="N",
        help="budget controller ceiling: prefill chunks a tick (default 4)")
    g.add_argument(
        "--sim-clock", type=float, default=None, metavar="DT",
        help="drive the engine with a simulated clock advancing DT seconds "
             "a reading instead of wall time")
    g.add_argument(
        "--bursty-trace", action="store_true",
        help="the seeded bursty mixed-priority trace instead of the "
             "uniform synthetic one")
    g.add_argument(
        "--burst-size", type=int, default=4, metavar="N",
        help="requests per burst in --bursty-trace (default 4)")
    g.add_argument(
        "--burst-gap-s", type=float, default=0.05, metavar="S",
        help="gap between bursts on the engine clock (default 0.05)")
    g.add_argument(
        "--temperature", type=float, default=0.0, metavar="T",
        help="sampling temperature (0 = greedy; host-side, per-request "
             "seeded streams)")
    g.add_argument(
        "--top-p", type=float, default=1.0, metavar="P",
        help="nucleus sampling mass (with --temperature > 0)")
    g.add_argument(
        "--metrics-json", default=None, metavar="PATH",
        help="write the engine's serve metrics JSON here")
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
