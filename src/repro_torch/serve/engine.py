"""Continuous-batching serving engine: fixed slot lanes, streaming requests
(port of ``repro.serve.engine``).

The step loop decouples request lifecycle (host-side scheduler) from the
step functions (device-side, fixed shapes, each a captured CUDA graph per
shape bucket on the card: ``train.servestep``):

* every tick runs ONE masked decode step for all ``num_slots`` lanes —
  vacant lanes are fed the pad token and excluded from sampling, and their
  cache position does not advance;
* admissions interleave between ticks. On the contiguous layout a
  single-request prefill (prompt right-padded to ``prompt_pad``) writes the
  slot's cache region in one shot. On the **paged** layout
  (``kv_block_size``) admission binds a lane and allocates KV blocks; the
  prompt then prefills chunk by chunk, interleaved with decode;
* eviction on stop-id / max-new-tokens frees the lane (and, paged, returns
  the request's blocks to the pool) for the queue head;
* admission order is a pluggable policy (``sched_policy``: fifo /
  priority / edf / prefix); preemptive policies evict and requeue strictly
  lower-ranked decodes under lane/block pressure. A per-tick **prefill
  budget** (``ttft_target_ms``) adapts how many chunked-prefill calls run
  per tick from observed TTFT;
* with the **prefix cache** (paged only), admission maps any cached prompt
  prefix's blocks straight into the slot's block table.

Slot count, chunk buckets, max_len and model dims are fixed at engine
build, so every tick issues one GEMM-signature set. ``plan_warmup`` solves
it by running the raw steps on the meta device, then ``run`` asserts zero
lazy plan solves (``PlanCache.expect_steady_state``). The decode state is
allocated once: the captured graphs hold its addresses, so ``reset``
zeroes it in place.

Sampling is host-side and per-request: greedy at ``temperature=0``, else
temperature + top-p from a per-request seeded stream.

Not ported yet: speculative lanes (ROADMAP queue 1, item 7), the int8 KV
pool (item 6), the tracer, registry and attribution ledger (item 8).
"""
from __future__ import annotations

import collections
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch import interop, models
from repro_torch.configs.base import ModelConfig, dtype_name
from repro_torch.core.context import current_context
from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.policy import BudgetController, SchedPolicy, get_policy
from repro_torch.serve.prefixcache import PrefixCache
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.train.servestep import (
    make_engine_step, make_paged_engine_step)


def chunk_buckets(chunk: int) -> tuple[int, ...]:
    """Bucket lengths chunked prefill pads to: {chunk/4, chunk/2, chunk}.

    Full chunks use the largest bucket; a prompt's tail rounds up to the
    smallest covering bucket — so prefill issues at most 3 distinct GEMM
    signatures (and graphs) instead of one per prompt length.
    """
    return tuple(sorted({max(1, chunk // 4), max(1, chunk // 2), chunk}))


def kv_block_bytes(cfg: ModelConfig, block_size: int,
                   dtype: torch.dtype) -> int:
    """Bytes one pool block holds across the layers, K and V."""
    return (cfg.n_layers * 2 * block_size * cfg.n_kv_heads * cfg.head_dim
            * dtype.itemsize)


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        num_slots: int,
        max_len: int,
        prompt_pad: int,
        pad_id: int = 0,
        kv_block_size: int | None = None,
        num_kv_blocks: int | None = None,
        prefill_chunk: int | None = None,
        prefix_cache: bool = False,
        prefix_cache_blocks: int | None = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        sched_policy: str | SchedPolicy | None = None,
        ttft_target_ms: float | None = None,
        max_prefill_chunks: int = 4,
        clock=None,
    ):
        self.cfg = cfg
        self.params = params
        self.device = next(t for _, t in interop.tree_items(params)).device
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_pad = prompt_pad
        self.pad_id = pad_id
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.sched_policy = get_policy(sched_policy)
        self.ttft_target_ms = ttft_target_ms
        self.max_prefill_chunks = max_prefill_chunks
        # injectable clock (policy.SimClock in tests): TTFT, deadlines and
        # burst arrivals become deterministic functions of the event
        # sequence
        self._now = clock if clock is not None else time.perf_counter
        self.paged = bool(kv_block_size)
        if prefix_cache and not self.paged:
            raise ValueError(
                "the prefix cache shares KV at block granularity — it "
                "needs the paged engine (kv_block_size)")
        if self.sched_policy.preemptive and not self.paged:
            raise ValueError(
                f"policy {self.sched_policy.name!r} preempts via block "
                f"refcounts — it needs the paged engine (kv_block_size)")
        self.prefix_cache_enabled = bool(prefix_cache)
        self.prefix_cache_blocks = prefix_cache_blocks
        if self.paged:
            self.kv_block_size = int(kv_block_size)
            # default pool: full contiguous capacity (+ the null block)
            full = -(-num_slots * max_len // self.kv_block_size) + 1
            self.num_kv_blocks = int(num_kv_blocks or full)
            self.prefill_chunk = int(prefill_chunk or prompt_pad)
            self.chunk_buckets = chunk_buckets(self.prefill_chunk)
            self.art = make_paged_engine_step(
                cfg, max_len=max_len, kv_block_size=self.kv_block_size,
                num_kv_blocks=self.num_kv_blocks,
                chunk_buckets=self.chunk_buckets, device=self.device)
        else:
            self.kv_block_size = None
            self.num_kv_blocks = None
            self.prefill_chunk = None
            self.chunk_buckets = None
            self.art = make_engine_step(cfg, max_len=max_len,
                                        prompt_pad=prompt_pad,
                                        device=self.device)
        self.state = None
        self._warmed = False
        self.reset()

    def _new_state(self, device) -> dict:
        return models.init_decode_state(
            self.cfg, self.num_slots, self.max_len, per_slot=True,
            kv_block_size=self.kv_block_size,
            num_kv_blocks=self.num_kv_blocks, device=device)

    def _rel_now(self) -> float:
        """Seconds on the engine clock since the last reset — the time
        base every stamp, deadline and ``arrival_s`` lives in."""
        return self._now() - self._t0

    # ------------------------------------------------------------ state
    def reset(self) -> None:
        """Fresh scheduler, metrics and a zeroed state; the captured steps
        are kept (their graphs hold the state's addresses, so the state is
        zeroed in place, never reallocated)."""
        ctx = current_context()
        self._t0 = self._now()
        if self.state is None:
            self.state = self._new_state(self.device)
        else:
            for _, t in interop.tree_items(self.state):
                t.zero_()
        pool = (BlockPool(self.num_kv_blocks, self.kv_block_size,
                          bytes_per_block=kv_block_bytes(
                              self.cfg, self.kv_block_size, self.cfg.dtype))
                if self.paged else None)
        cache = (PrefixCache(pool, max_cached_blocks=self.prefix_cache_blocks)
                 if self.prefix_cache_enabled else None)
        self.sched = SlotScheduler(self.num_slots, max_len=self.max_len,
                                   pool=pool, prefix_cache=cache,
                                   policy=self.sched_policy)
        self.budget = BudgetController(
            None if self.ttft_target_ms is None
            else self.ttft_target_ms / 1e3,
            max_chunks=self.max_prefill_chunks)
        self._next_tok = np.full((self.num_slots,), self.pad_id, np.int64)
        # step calls by phase ("decode", "admit", "prefill-chunk@<bucket>"):
        # with the dispatch rule they give the kernel launches of a run
        self.dispatches: collections.Counter = collections.Counter()
        engine_info = {
            "arch": self.cfg.name,
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "prompt_pad": self.prompt_pad,
            "hw": ctx.hw.name,
            "backend": self.device.type,
            "quant": ctx.quant_mode,
            "paged": self.paged,
            "temperature": self.temperature,
            "top_p": self.top_p,
            "sched_policy": self.sched_policy.name,
            "ttft_target_ms": self.ttft_target_ms,
        }
        if self.paged:
            engine_info.update(
                kv_block_size=self.kv_block_size,
                num_kv_blocks=self.num_kv_blocks,
                kv_dtype=dtype_name(self.cfg.dtype),
                prefill_chunk=self.prefill_chunk,
                chunk_buckets=list(self.chunk_buckets),
                prefix_cache=self.prefix_cache_enabled,
                prefix_cache_blocks=self.prefix_cache_blocks)
        self.metrics = EngineMetrics(engine=engine_info)

    # ------------------------------------------------------------ warm-up
    def plan_warmup(self) -> dict[str, int]:
        """Pre-solve every GEMM signature the engine's steps issue by running
        the raw steps on the meta device (the engine-shaped counterpart of
        ``core.gemm.plan_model``): one chunked-prefill step per bucket (or
        the admit step) plus the decode tick. Marks the engine warm:
        later ``run`` calls assert steady state. The graphs are captured
        after this, at each bucket's first call."""
        cache = current_context().plan_cache
        before = cache.stats.snapshot()
        meta = lambda shape: torch.empty(shape, dtype=torch.int64,
                                         device="meta")
        params = interop.tree_map(
            lambda t: torch.empty_like(t, device="meta"), self.params)
        state = self._new_state("meta")
        with cache.warmup():
            if self.paged:
                for bucket in self.chunk_buckets:
                    self.art.prefill_raw(params, state, meta((1, bucket)),
                                         meta(()), meta(()), meta(()),
                                         meta((self.art.max_blocks,)))
            else:
                self.art.admit_raw(params, state, meta((1, self.prompt_pad)),
                                   meta(()), meta(()))
            self.art.decode_raw(params, state, meta((self.num_slots, 1)),
                                meta((self.num_slots,)))
        self._warmed = True
        solved = cache.stats.warm_solves - before.warm_solves
        signatures = len(cache.warm_keys)
        return {"signatures": signatures, "solved": solved,
                "from_cache": signatures - solved}

    # ------------------------------------------------------------ intake
    def submit(self, request: Request, now_s: float | None = None) -> Request:
        if not self.paged and request.prompt_len > self.prompt_pad:
            raise ValueError(
                f"prompt_len={request.prompt_len} exceeds the engine's "
                f"prompt_pad={self.prompt_pad}")
        return self.sched.submit(
            request, now_s if now_s is not None else self._rel_now())

    # ------------------------------------------------------------ sampling
    def _sample(self, logits_row: np.ndarray, st: RequestState) -> int:
        """Sample one token for ``st`` from its lane's logits (host-side;
        the padded vocab tail is never sampled). Greedy at temperature 0,
        else temperature + top-p nucleus sampling from the request's seeded
        stream."""
        req = st.request
        logits = np.asarray(logits_row[: self.cfg.vocab_size], np.float64)
        temp = (req.temperature if req.temperature is not None
                else self.temperature)
        if temp is None or temp <= 0.0:
            return int(np.argmax(logits))
        top_p = req.top_p if req.top_p is not None else self.top_p
        z = logits / temp
        z -= z.max()
        probs = np.exp(z)
        probs /= probs.sum()
        if top_p < 1.0:
            order = np.argsort(-probs, kind="stable")
            csum = np.cumsum(probs[order])
            # smallest prefix with mass >= top_p (the boundary token stays)
            cut = int(np.searchsorted(csum, top_p)) + 1
            keep = order[:cut]
            mask = np.zeros_like(probs)
            mask[keep] = probs[keep]
            probs = mask / mask.sum()
        if st.rng is None:
            st.rng = np.random.default_rng(
                req.seed if req.seed is not None
                else [self.seed, st.admission_index])
        return int(st.rng.choice(probs.shape[0], p=probs))

    # ------------------------------------------------------------ ticking
    def _finish(self, st: RequestState, reason: str, now: float) -> None:
        self.sched.evict(st.slot, reason, now)
        self.metrics.record_request(st)

    def _budget(self, st: RequestState) -> int:
        """Effective generation budget (``Request.budget``, shared with the
        scheduler's block-allocation sizing)."""
        return st.request.budget(self.max_len)

    def _first_token(self, st: RequestState, logits: np.ndarray,
                     now: float) -> None:
        """Record the first token falling out of a completed prefill (a
        resumed prefill lands here too; only a first token ever feeds the
        budget controller's TTFT loop)."""
        first_ever = st.first_token_s is None
        tok = self._sample(logits, st)
        st.append(tok, now, tick=self.sched.tick)
        if first_ever:
            self.budget.observe_ttft(now - st.request.submitted_s)
        self._next_tok[st.slot] = tok
        reason = ("length" if len(st.tokens) >= self._budget(st)
                  else st.should_stop())
        if reason:
            self._finish(st, reason, now)

    def _admit_all(self, now: float) -> int:
        """Contiguous path: drain the queue into free lanes; each admission
        prefills in one shot and yields the request's first token. Returns
        tokens produced."""
        n = 0
        while True:
            st = self.sched.admit_next(now)
            if st is None:
                return n
            n += 1
            req = st.request
            prompt = np.full((1, self.prompt_pad), self.pad_id, np.int64)
            prompt[0, : req.prompt_len] = req.prompt
            self.dispatches["admit"] += 1
            logits = self.art.admit_fn(self.params, self.state, prompt,
                                       st.slot, req.prompt_len)
            self._first_token(st, logits.cpu().numpy(), self._rel_now())

    def _chunk_shape(self, remaining: int) -> tuple[int, int]:
        """(bucket_len, true_len) for the next prefill chunk."""
        if remaining >= self.prefill_chunk:
            return self.prefill_chunk, self.prefill_chunk
        for b in self.chunk_buckets:
            if b >= remaining:
                return b, remaining
        return self.prefill_chunk, remaining  # unreachable; buckets cover it

    def _prefill_tick(self, now: float) -> int:
        """Run ONE chunked-prefill step for the oldest mid-prefill lane.
        The final chunk yields the request's first token (or, resumed, the
        next token of the stream). Returns tokens produced (0 or 1)."""
        st = self.sched.prefill_head()
        if st is None:
            return 0
        # the prefill sequence is the admission snapshot: the bare prompt
        # for a fresh request, prompt + generated-so-far for a resume
        seq = (st.prefill_tokens if st.prefill_tokens is not None
               else st.request.prompt)
        start = st.prefill_done
        bucket, n = self._chunk_shape(st._target - start)
        chunk = np.full((1, bucket), self.pad_id, np.int64)
        chunk[0, :n] = seq[start: start + n]
        blocks = np.zeros((self.art.max_blocks,), np.int64)
        blocks[: len(st.blocks)] = st.blocks
        self.dispatches[f"prefill-chunk@{bucket}"] += 1
        logits = self.art.prefill_fn(self.params, self.state, chunk, st.slot,
                                     start, n, blocks)
        self.sched.prefill_advance(st.slot, n)
        if st.prefilling:
            return 0
        self._first_token(st, logits.cpu().numpy(), self._rel_now())
        return 1

    def tick(self) -> int:
        """One engine tick: deadline sweep, admissions (plus, paged, up to
        ``budget.chunks_per_tick()`` prefill chunks), then one masked
        decode step for the decode-ready lanes. Returns the number of
        tokens generated."""
        now = self._rel_now()
        for st in self.sched.expire_deadlines(now):
            self.metrics.record_request(st)
        if self.paged:
            while self.sched.admit_next(now) is not None:
                pass
            produced = 0
            # the budget controller's knob: how much of this tick goes to
            # prefill (TTFT) vs decode (throughput), over the same buckets
            for _ in range(self.budget.chunks_per_tick()):
                if self.sched.prefill_head() is None:
                    break
                produced += self._prefill_tick(now)
        else:
            produced = self._admit_all(now)
        mask = self.sched.decode_mask()
        ready = int(mask.sum())
        if ready:
            toks = np.where(mask, self._next_tok, self.pad_id)
            self.dispatches["decode"] += 1
            logits = self.art.decode_fn(self.params, self.state,
                                        toks[:, None], mask.astype(np.int64))
            np_logits = logits.cpu().numpy()
            now = self._rel_now()
            for slot in np.flatnonzero(mask):
                st = self.sched.slots[slot]
                tok = self._sample(np_logits[slot], st)
                st.append(tok, now, tick=self.sched.tick)
                self._next_tok[slot] = tok
                produced += 1
                reason = ("length" if len(st.tokens) >= self._budget(st)
                          else st.should_stop())
                if reason:
                    self._finish(st, reason, now)
        if self.paged:
            self.metrics.record_block_pool(
                self.sched.pool, self.sched.live_tokens(),
                contiguous_tokens=self.num_slots * self.max_len)
        # occupancy counts lanes that decoded this tick (token-steps
        # computed); mid-prefill lanes are visible in the prefill metrics
        self.metrics.record_tick(ready, produced, self.sched.pending)
        self.sched.tick += 1
        return produced

    # ------------------------------------------------------------ driving
    def run(self, requests: Iterable[Request] = ()) -> EngineMetrics:
        """Run ``requests`` to completion and return the filled metrics.

        Arrival-aware: a request is submitted once the engine clock reaches
        its ``arrival_s``; one whose deadline passed while it waited to
        arrive is terminal-missed without ever queueing. After
        ``plan_warmup`` the loop runs under the zero-lazy-solve assertion.
        """
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.request_id))
        cache = current_context().plan_cache
        before = cache.stats.snapshot()
        t_start = self._rel_now()

        def step():
            now = self._rel_now()
            while pending and pending[0].arrival_s <= now:
                r = pending.pop(0)
                if r.deadline_s is not None and r.deadline_s <= now:
                    self.metrics.record_request(
                        self.sched.drop_expired(r, now))
                else:
                    self.sched.submit(r, now)
            self.tick()

        if self._warmed:
            with cache.expect_steady_state("serve-engine loop"):
                while pending or not self.sched.idle:
                    step()
        else:
            while pending or not self.sched.idle:
                step()
        self.metrics.wall_s = self._rel_now() - t_start
        self.metrics.record_plan_cache(before, cache.stats.snapshot())
        counters = self.sched.counters()
        self.metrics.admissions = counters["admissions"]
        self.metrics.evictions = counters["evictions"]
        self.metrics.deferred_admissions = counters["deferred_admissions"]
        self.metrics.preemptions = counters["preemptions"]
        self.metrics.resumes = counters["resumes"]
        self.metrics.deadline_missed = counters["deadline_missed"]
        self.metrics.policy = counters["policy"]
        self.metrics.budget = self.budget.stats()
        if self.paged:
            self.metrics.record_kv_cache(
                kv_dtype=dtype_name(self.cfg.dtype),
                bytes_per_block=self.sched.pool.bytes_per_block,
                num_blocks=self.num_kv_blocks,
                bf16_bytes_per_block=kv_block_bytes(
                    self.cfg, self.kv_block_size, torch.bfloat16))
        if self.sched.prefix_cache is not None:
            self.metrics.record_prefix_cache(self.sched.prefix_cache)
        self.metrics.slo_burn = self.metrics.slo_burn_summary(
            None if self.ttft_target_ms is None
            else self.ttft_target_ms / 1e3)
        return self.metrics

    @property
    def finished(self) -> list[RequestState]:
        return self.sched.finished
