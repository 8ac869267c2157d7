"""Shared launcher arguments (port of ``repro.launch.args``): the context
layer (``--hw``, ``--quantize``, ``--plan-cache``, ``--device``) and the
serving-engine layer (``--engine`` and what it honours, ``--kv-quantize``,
speculative decoding's ``--spec-*``, and the flight recorder, registry,
measured plan tuning and balance auditor: ``--trace-out``,
``--trace-ring-events``, ``--metrics-interval-ticks``, ``--measure-plans``,
``--attrib-tol``, ``--rebalance-drifted``).

``--hw`` defaults to ``$REPRO_TORCH_HW``, else ``h100``; ``--plan-cache ''``
keeps plans in memory only; ``--device`` defaults to ``cuda`` (there is no
fallback to the CPU: ``--device cpu`` asks for the plain path).
"""
from __future__ import annotations

import argparse

from repro_torch.core.context import GemmContext
from repro_torch.core.hwregistry import default_hw, list_hw
from repro_torch.core.plancache import PlanCache, default_cache_path


def add_context_args(ap: argparse.ArgumentParser, *,
                     include_quant: bool = True) -> argparse.ArgumentParser:
    """``include_quant=False``: no ``--quantize`` (the trainer: the int8
    path does not train)."""
    g = ap.add_argument_group("execution context")
    g.add_argument(
        "--hw", default=None, metavar="GEN",
        help=f"hardware generation for the GEMM planner/perf model "
             f"({', '.join(list_hw())}; default: $REPRO_TORCH_HW or h100)")
    if include_quant:
        g.add_argument(
            "--quantize", default="none", choices=["none", "int8"],
            help="int8: quantize every projection weight once at load and "
                 "route each GEMM through the W8A8 path (int8 x int8, the "
                 "per-channel requantize in the kernel's epilogue)")
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
    """The serving-engine layer: the reference's flags, with its defaults."""
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
        "--kv-quantize", default="none", choices=["none", "int8"],
        help="quantize the paged KV pool's blocks (needs --kv-block-size): "
             "int8 blocks plus per-block, per-kv-head f32 scales, "
             "dequantized inside the table-walking gather; ~0.5x the pool "
             "bytes")
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
        "--spec-draft-config", default=None, metavar="ARCH",
        help="enable speculative decoding: draft-model architecture "
             "(repro_torch.configs name) that proposes tokens for the target "
             "to verify in one batched pass (paged engine, greedy only; "
             "--smoke shrinks the draft alongside the target)")
    g.add_argument(
        "--spec-k", type=int, default=4, metavar="K",
        help="speculation depth: the draft proposes K tokens a lane a "
             "round, the target verifies K+1 positions (default 4)")
    g.add_argument(
        "--spec-draft-quantize", default="int8", choices=["none", "int8"],
        help="quantize the draft's weights once at load (the --quantize "
             "int8 recipe; default int8: the draft exists to be cheap)")
    g.add_argument(
        "--metrics-json", default=None, metavar="PATH",
        help="write the engine's serve metrics JSON here")
    g.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="flight recorder: write a Chrome trace-event JSON of the run "
             "(phase spans, on the card with each device phase's CUDA-event "
             "time in its args, and per-request async spans; load in "
             "Perfetto or chrome://tracing). Also adds the `timing` and "
             "`attribution` sections to the metrics JSON")
    g.add_argument(
        "--trace-ring-events", type=int, default=65536, metavar="N",
        help="tracer ring-buffer capacity in events; oldest events drop "
             "past it (default 65536 ~ 16k ticks of phase spans)")
    g.add_argument(
        "--metrics-interval-ticks", type=int, default=None, metavar="N",
        help="snapshot the counter registry every N engine ticks and "
             "write its Prometheus text exposition next to "
             "--metrics-json (default: end-of-run publish only)")
    g.add_argument(
        "--measure-plans", action="store_true",
        help="refine warm-up plans in place by timing the fat GEMM kernel "
             "at each plan and its neighbouring built tiles (CUDA events "
             "on the card, the plain version on the CPU; core.autotune) "
             "and persist the refined plans")
    g.add_argument(
        "--attrib-tol", type=float, default=0.25, metavar="F",
        help="balance-auditor drift tolerance: a cached plan whose "
             "current model evaluation deviates from its solve-time "
             "snapshot by more than F (relative t_total or balance "
             "ratio) is flagged drifted (default 0.25)")
    g.add_argument(
        "--rebalance-drifted", action="store_true",
        help="after a traced run, feed the warm plans the balance "
             "auditor flagged as drifted into autotune.refine_cached_"
             "plans(resolve=True) — model re-solve + hillclimb — and "
             "persist the restored plans (needs --trace-out)")
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
        quant_mode=getattr(args, "quantize", "none"),
        plan_cache=cache,
    )
