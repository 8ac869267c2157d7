"""repro_torch.serve — the continuous-batching serving engine (port of
``repro.serve``).

Request lifecycle (``request``) is host-side and dynamic; the step
functions (``train.servestep``) are fixed-shape, captured as CUDA graphs on
the card; the scheduler (``scheduler``) maps one onto the other through
``num_slots`` decode lanes — with paged KV (``blockpool``), the lanes'
cache is a block pool indexed by per-slot block tables and prompts prefill
chunk by chunk; ``prefixcache`` deduplicates shared prompt prefixes over
those tables; ``policy`` orders admission, preempts and adapts the
per-tick prefill budget; ``spec`` holds speculative decoding's acceptance
rule and rollback math (a draft model proposes k tokens a lane, the target
verifies them in one batched pass: ``train.servestep.make_spec_step``);
``engine`` runs the tick loop and ``metrics`` reports it.
"""
from repro_torch.serve.blockpool import BlockPool, blocks_for
from repro_torch.serve.engine import ServeEngine, chunk_buckets
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.policy import (POLICIES, BudgetController, EdfPolicy,
                                      FifoPolicy, PrefixAffinityPolicy,
                                      PriorityPolicy, SchedPolicy, SimClock,
                                      get_policy)
from repro_torch.serve.prefixcache import PrefixCache
from repro_torch.serve.request import (Request, RequestState, bursty_trace,
                                       shared_prefix_trace, synthetic_trace)
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.spec import (SpecStats, accept_prefix, draft_sync,
                                    verify_rewind)

__all__ = [
    "ServeEngine", "EngineMetrics", "Request", "RequestState",
    "SlotScheduler", "BlockPool", "PrefixCache", "blocks_for",
    "chunk_buckets", "synthetic_trace", "shared_prefix_trace",
    "bursty_trace", "SchedPolicy", "FifoPolicy", "PriorityPolicy",
    "EdfPolicy", "PrefixAffinityPolicy", "POLICIES", "get_policy",
    "BudgetController", "SimClock", "SpecStats", "accept_prefix",
    "verify_rewind", "draft_sync",
]
