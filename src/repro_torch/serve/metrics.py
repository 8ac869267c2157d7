"""Serving metrics: per-request latency, aggregate throughput, slot
occupancy and plan-cache warmth — exportable as JSON (port of
``repro.serve.metrics``).

The ``EngineMetrics.to_dict`` schema is the reference's, ``speculation``
included (``{"enabled": false}`` unless the engine speculates). Every leaf
the port exports matches a pattern of the reference's golden schema
(``tests/test_metrics_schema.py``; checked by
``tests/test_torch_engine.py``).

Conventions worth restating at the source:

* The ``timing`` (per-phase host seconds: count, total, mean, p50, p99,
  and the host/device split) and ``attribution`` (the balance auditor's
  per-signature join, ``obs.attrib``) sections exist only on traced runs
  (an attached ``repro_torch.obs.Tracer``); untraced metrics JSON is the
  same as without a tracer.

* Ratios whose denominator never moved are ``None``, not ``0.0``: a
  SimClock run can legitimately finish inside one clock resolution step
  (``wall_s == 0``), and "throughput unknown" must not export as
  "throughput zero". Every wall-time rate has a deterministic tick-based
  twin (``tokens_per_tick``, ``ttft_ticks``, ``p99_ttft_ticks``) that is
  exact under any clock.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from repro_torch.core.plancache import PlanCacheStats
from repro_torch.serve.request import RequestState


@dataclasses.dataclass
class EngineMetrics:
    engine: dict[str, Any] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    ticks: int = 0
    generated_tokens: int = 0
    occupancy_sum: int = 0        # sum over ticks of occupied slots
    queue_peak: int = 0
    admissions: int = 0
    deferred_admissions: int = 0
    evictions: dict[str, Any] = dataclasses.field(default_factory=dict)
    preemptions: int = 0
    resumes: int = 0
    deadline_missed: int = 0
    policy: str = "fifo"
    budget: dict[str, Any] = dataclasses.field(default_factory=dict)
    requests: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    block_pool: dict[str, Any] = dataclasses.field(default_factory=dict)
    kv_cache: dict[str, Any] = dataclasses.field(default_factory=dict)
    prefix_cache: dict[str, Any] = dataclasses.field(default_factory=dict)
    plan_cache: dict[str, Any] = dataclasses.field(default_factory=dict)
    # traced runs only
    timing: dict[str, Any] = dataclasses.field(default_factory=dict)
    attribution: dict[str, Any] = dataclasses.field(default_factory=dict)
    speculation: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"enabled": False})
    # SLO burn-rate monitor (always exported; deterministic)
    slo_burn: dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ record
    def record_tick(self, occupied: int, new_tokens: int,
                    queued: int) -> None:
        self.ticks += 1
        self.occupancy_sum += occupied
        self.generated_tokens += new_tokens
        self.queue_peak = max(self.queue_peak, queued)

    def record_request(self, st: RequestState) -> None:
        req = st.request
        # admitted_tick == -1: a deadline miss that never reached a lane
        # (dropped from the queue, or expired before it could arrive) —
        # it has no admission, TTFT or queueing delay, only a finish
        admitted = st.admitted_tick >= 0
        total_s = (None if st.finished_s is None or not admitted
                   else st.finished_s - st.admitted_s)
        n = len(st.tokens)
        self.requests.append({
            "request_id": req.request_id,
            "priority": req.priority,
            "deadline_s": req.deadline_s,
            "prompt_len": req.prompt_len,
            "cached_tokens": st.cached_tokens,
            "tokens": n,
            "queue_s": (st.admitted_s - req.submitted_s if admitted
                        else None),
            "ttft_s": (None if st.first_token_s is None or not admitted
                       else st.first_token_s - st.admitted_s),
            "ttft_ticks": (None if st.first_token_tick is None
                           or req.arrival_tick < 0
                           else st.first_token_tick - req.arrival_tick),
            "total_s": total_s,
            "per_token_s": (total_s / n if total_s is not None and n else None),
            "preemptions": st.preemptions,
            "finish_reason": st.finish_reason,
            "arrival_tick": req.arrival_tick,
            "admitted_tick": st.admitted_tick,
            "finished_tick": st.finished_tick,
        })

    def record_block_pool(self, pool, live_tokens: int, *,
                          contiguous_tokens: int) -> None:
        """Fold the allocator's current state into the running block-pool
        section (peaks are monotone; called every tick, cheap dict math)."""
        stats = pool.stats()
        frag = pool.fragmentation_tokens(live_tokens)
        prev = self.block_pool
        stats["peak_fragmentation_tokens"] = max(
            frag, prev.get("peak_fragmentation_tokens", 0))
        stats["pool_tokens"] = pool.num_blocks * pool.block_size
        stats["contiguous_tokens"] = contiguous_tokens
        stats["memory_ratio"] = (stats["pool_tokens"] / contiguous_tokens
                                 if contiguous_tokens else 0.0)
        self.block_pool = stats

    def record_kv_cache(self, *, kv_dtype: str, bytes_per_block: int,
                        num_blocks: int, bf16_bytes_per_block: int,
                        scale_stats: dict[str, Any] | None = None) -> None:
        """KV-cache storage accounting (paged engines; engine.run, once).
        ``kv_dtype`` is the pool's format (``quant.kvcache.KVCacheDtype``);
        ``bytes_ratio`` is the pool's bytes relative to the same pool
        stored bf16 (about 0.5 for int8 with its scales). ``scale_stats``
        (int8 pools) are the dequant-error gauges: the mean and max of the
        written blocks' scales (a block's worst-case error is scale/2)."""
        self.kv_cache = {
            "kv_dtype": kv_dtype,
            "quantized": kv_dtype != "bf16",
            "bytes_per_block": bytes_per_block,
            "pool_bytes": num_blocks * bytes_per_block,
            "bf16_pool_bytes": num_blocks * bf16_bytes_per_block,
            "bytes_ratio": (bytes_per_block / bf16_bytes_per_block
                            if bf16_bytes_per_block else None),
        }
        if scale_stats:
            self.kv_cache.update(scale_stats)

    def record_prefix_cache(self, cache) -> None:
        """Snapshot the radix cache's cumulative counters (engine.run calls
        this once per run; the cache object is reset with the engine)."""
        self.prefix_cache = cache.stats()

    def record_speculation(self, stats, *, draft_arch: str | None = None,
                           draft_quant: str | None = None) -> None:
        """Snapshot the engine's SpecStats into the ``speculation``
        section (engine.run, once per run with speculation enabled)."""
        out = stats.to_dict()
        out["draft_arch"] = draft_arch
        out["draft_quant"] = draft_quant
        self.speculation = out

    def record_plan_cache(self, before: PlanCacheStats,
                          after: PlanCacheStats) -> None:
        lazy = after.lazy_solves - before.lazy_solves
        misses = after.misses - before.misses
        self.plan_cache = {
            "hits": after.hits - before.hits,
            "misses": misses,
            "lazy_solves": lazy,
            "warm_solves": after.warm_solves - before.warm_solves,
            "steady_state": lazy == 0 and misses == 0,
        }

    # ------------------------------------------------------------ export
    def slo_summary(self) -> dict[str, Any]:
        """Per-priority-class SLO rollup over the recorded requests.

        TTFT here is the user-visible submit→first-token latency (queueing
        included); ``*_ticks`` is its deterministic engine-tick twin —
        exact under SimClock, so benchmarks/CI gate on it. Requests that
        never produced a token (deadline-missed in the queue) have no
        TTFT sample but do count toward ``miss_rate``."""
        by_prio: dict[int, list[dict]] = {}
        for r in self.requests:
            by_prio.setdefault(int(r["priority"]), []).append(r)
        out: dict[str, Any] = {}
        for prio in sorted(by_prio):
            rs = by_prio[prio]
            ttft_s = [r["queue_s"] + r["ttft_s"] for r in rs
                      if r["queue_s"] is not None and r["ttft_s"] is not None]
            ticks = [r["ttft_ticks"] for r in rs
                     if r["ttft_ticks"] is not None]
            missed = sum(r["finish_reason"] == "deadline_missed" for r in rs)
            pct = lambda xs, q: (float(np.percentile(xs, q)) if xs else None)
            out[str(prio)] = {
                "n": len(rs),
                "finished": sum(r["finish_reason"] in ("stop", "length")
                                for r in rs),
                "deadline_missed": missed,
                "miss_rate": missed / len(rs) if rs else 0.0,
                "preemptions": sum(r["preemptions"] for r in rs),
                "p50_ttft_s": pct(ttft_s, 50),
                "p99_ttft_s": pct(ttft_s, 99),
                "p50_ttft_ticks": pct(ticks, 50),
                "p99_ttft_ticks": pct(ticks, 99),
            }
        return out

    def slo_burn_summary(self, target_ttft_s: float | None, *,
                         window: int = 32,
                         budget_miss_rate: float = 0.1) -> dict[str, Any]:
        """Rolling TTFT-miss budget per priority class (SRE burn rate).

        A request *misses* when its user-visible TTFT (queue + ttft) exceeds
        ``target_ttft_s``, or when it died with ``deadline_missed``. The
        rolling window is the last ``window`` requests per class in finish
        order — deterministic under SimClock. ``burn_rate`` is the rolling
        miss rate over the budgeted rate (> 1.0 means the class is burning
        its error budget faster than allowed → ``alert``). With no TTFT
        target only hard deadline misses count.
        """
        by_prio: dict[int, list[dict]] = {}
        for r in self.requests:
            by_prio.setdefault(int(r["priority"]), []).append(r)

        def _missed(r: dict) -> bool:
            if r["finish_reason"] == "deadline_missed":
                return True
            if target_ttft_s is None:
                return False
            if r["queue_s"] is None or r["ttft_s"] is None:
                return False
            return (r["queue_s"] + r["ttft_s"]) > target_ttft_s

        classes: dict[str, Any] = {}
        for prio in sorted(by_prio):
            rs = by_prio[prio]
            recent = rs[-window:]
            misses = sum(_missed(r) for r in recent)
            rate = misses / len(recent) if recent else None
            burn = (rate / budget_miss_rate
                    if rate is not None and budget_miss_rate > 0 else None)
            classes[str(prio)] = {
                "n": len(rs),
                "window_n": len(recent),
                "misses_in_window": misses,
                "rolling_miss_rate": rate,
                "burn_rate": burn,
                "alert": bool(burn is not None and burn > 1.0),
            }
        return {
            "target_ttft_s": target_ttft_s,
            "window": window,
            "budget_miss_rate": budget_miss_rate,
            "classes": classes,
        }

    @property
    def tokens_per_sec(self) -> float | None:
        """Wall-clock throughput, or None when wall_s never advanced (a
        SimClock run can finish inside one resolution step — "unknown",
        not zero). ``tokens_per_tick`` is the deterministic twin."""
        return (self.generated_tokens / self.wall_s if self.wall_s > 0
                else None)

    @property
    def tokens_per_tick(self) -> float | None:
        """Throughput per engine tick — exact under any clock."""
        return self.generated_tokens / self.ticks if self.ticks else None

    @property
    def mean_occupancy(self) -> float | None:
        return self.occupancy_sum / self.ticks if self.ticks else None

    def to_dict(self) -> dict[str, Any]:
        out = {
            "engine": dict(self.engine),
            "aggregate": {
                "wall_s": self.wall_s,
                "ticks": self.ticks,
                "generated_tokens": self.generated_tokens,
                "tokens_per_sec": self.tokens_per_sec,
                "tokens_per_tick": self.tokens_per_tick,
                "mean_occupancy": self.mean_occupancy,
                "admissions": self.admissions,
                "deferred_admissions": self.deferred_admissions,
                "evictions": dict(self.evictions),
                "preemptions": self.preemptions,
                "resumes": self.resumes,
                "deadline_missed": self.deadline_missed,
                "policy": self.policy,
                "queue_peak": self.queue_peak,
            },
            "requests": list(self.requests),
            "slo": self.slo_summary(),
            "slo_burn": dict(self.slo_burn),
            "budget": dict(self.budget),
            "block_pool": dict(self.block_pool),
            "kv_cache": dict(self.kv_cache),
            "prefix_cache": dict(self.prefix_cache),
            "speculation": dict(self.speculation),
            "plan_cache": dict(self.plan_cache),
        }
        if self.timing:
            out["timing"] = dict(self.timing)
        if self.attribution:
            out["attribution"] = dict(self.attribution)
        return out

    def to_json(self, path: str | None = None, **kw) -> str:
        s = json.dumps(self.to_dict(), indent=2, **kw)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s
