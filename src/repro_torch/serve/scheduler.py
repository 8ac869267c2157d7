"""Slot-based scheduler: policy-ordered admission onto fixed decode lanes.

The engine's decode step is compiled once for ``num_slots`` lanes; the
scheduler's whole job is to keep that shape true while requests come and go:

* ``submit`` validates the request and appends it to the queue;
* ``admit_next`` binds the request the **admission policy** selects to the
  lowest free slot — the engine then prefills the slot's KV (one shot on
  the contiguous layout, chunk by chunk on the paged one);
* ``evict`` frees a slot on EOS / max-length / deadline expiry so the next
  queued request can reuse the lane (same buffer, new length — no
  allocation);
* ``active_mask`` is the (num_slots,) occupancy; ``decode_mask`` excludes
  lanes whose prompt is still mid-chunked-prefill.

Admission order is a pluggable :class:`repro.serve.policy.SchedPolicy`
(``--sched-policy``): FIFO (default — arrival order, deferrals included,
the no-starvation guarantee of the pre-SLO scheduler), priority (highest
``Request.priority`` first), EDF (earliest ``deadline_s`` first) or
prefix-affinity (longest cached prompt prefix first). Whatever the
policy, only ONE candidate is tried per attempt: if its blocks aren't
there the attempt defers — later arrivals cannot steal from the policy's
own choice, so the no-starvation property holds *within the policy's
ordering*.

With a :class:`repro.serve.blockpool.BlockPool` attached, admission also
allocates the request's KV blocks — the whole prompt *plus* its effective
generation budget, so an admitted request can always run to completion. A
request whose prompt + budget could never fit even an empty pool is
refused at submit.

**Preemption** (preemptive policies, paged only): when the selected
request cannot get a lane or its blocks, a strictly lower-ranked
decode-phase lane is evicted and requeued. The victim keeps its
RequestState (tokens + sampling stream carry over); its full-block
written prefix — prompt plus generated tokens — is inserted into the
prefix trie before its block references drop, so the resume admission
matches those blocks straight back and re-prefills only the tail.
Output is token-for-token identical to an unpreempted run.

**Deadlines**: ``expire_deadlines(now_s)`` cancels queued requests and
evicts active lanes whose ``deadline_s`` has passed (reason
``deadline_missed``); the metrics layer reports the miss rate per
priority class.

Pure host-side Python (numpy only), trivially unit-testable: every method
that reads the clock takes an explicit ``now_s``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.policy import SchedPolicy, get_policy
from repro_torch.serve.prefixcache import PrefixCache
from repro_torch.serve.request import Request, RequestState


class SlotScheduler:
    def __init__(self, num_slots: int, *, max_len: int,
                 pool: BlockPool | None = None,
                 prefix_cache: PrefixCache | None = None,
                 policy: str | SchedPolicy | None = None, tracer=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if prefix_cache is not None and pool is None:
            raise ValueError("prefix_cache needs a BlockPool (paged KV)")
        if prefix_cache is not None and prefix_cache.pool is not pool:
            raise ValueError("prefix_cache is bound to a different pool")
        self.num_slots = num_slots
        self.max_len = max_len
        self.pool = pool
        self.prefix_cache = prefix_cache
        self.policy = get_policy(policy)
        # lifecycle event sink (repro.obs.trace); NULL_TRACER when untraced
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.queue: list[Request] = []
        self.slots: list[RequestState | None] = [None] * num_slots
        self.tick = 0
        self.finished: list[RequestState] = []
        self._paused: dict[int, RequestState] = {}  # preempted, by request_id
        self._admissions = 0
        self._deferred = 0
        self._evictions: dict[str, int] = {}  # terminal finish reasons
        self._preemptions = 0
        self._resumes = 0
        self._deadline_missed = 0
        self._prefill_order: list[int] = []   # slots mid-chunked-prefill

    # ------------------------------------------------------------ queue
    def submit(self, request: Request, now_s: float = 0.0) -> Request:
        request.validate(now_s)
        if request.prompt_len >= self.max_len:
            raise ValueError(
                f"prompt_len={request.prompt_len} does not fit max_len="
                f"{self.max_len} (need >= 1 token of decode headroom)")
        if self.pool is not None:
            need = self.pool.blocks_for(
                request.prompt_len + request.budget(self.max_len))
            if need > self.pool.usable_blocks:
                # byte-aware refusal: with KV quantization the same byte
                # budget holds ~2x the blocks, so the bytes figure is the
                # capacity knob an operator actually turns
                cap = f"{self.pool.capacity_tokens()} tokens"
                if self.pool.bytes_per_block is not None:
                    cap += f", {self.pool.pool_bytes()} pool bytes"
                raise ValueError(
                    f"prompt+budget needs {need} KV blocks but the pool has "
                    f"{self.pool.usable_blocks} usable "
                    f"({cap}) — the request could never be admitted")
        request.arrival_tick = self.tick
        request.submitted_s = now_s
        self.queue.append(request)
        self.tracer.request_event(
            "submit", request.request_id, prompt_len=request.prompt_len,
            priority=request.priority, deadline_s=request.deadline_s)
        return request

    @property
    def pending(self) -> int:
        return len(self.queue)

    # ------------------------------------------------------------ slots
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots], bool)

    def decode_mask(self) -> np.ndarray:
        """Lanes ready for the masked decode step: occupied AND past
        prefill (on the contiguous layout admission prefill is one shot,
        so every occupied lane qualifies)."""
        return np.array(
            [s is not None and not s.prefilling for s in self.slots], bool)

    def occupancy(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and self.occupancy() == 0

    def _pick_victim(self, candidate: Request) -> RequestState | None:
        """The lane the policy would evict for ``candidate`` — preemptive
        policies only, paged only (a contiguous resume could exceed the
        one-shot prefill pad)."""
        if self.pool is None:
            return None
        return self.policy.victim(
            candidate, [s for s in self.slots if s is not None])

    def admit_next(self, now_s: float = 0.0) -> RequestState | None:
        """Bind the policy's selected request to the lowest free slot;
        None if the queue is empty or the selection cannot run right now.
        Only the selected request is ever tried — a deferred selection
        re-checks on every tick and other queued requests cannot steal
        freed blocks from it. Preemptive policies may first evict a
        strictly lower-ranked decode lane to free a lane and/or its
        blocks; the victim is requeued for a later resume."""
        if not self.queue:
            return None
        idx = self.policy.select(self.queue, now_s=now_s,
                                 prefix_cache=self.prefix_cache)
        req = self.queue[idx]
        if not self.free_slots():
            victim = self._pick_victim(req)
            if victim is None:
                return None
            self.preempt(victim.slot, now_s)
        resume = self._paused.get(req.request_id)
        seq = resume.full_sequence() if resume is not None else req.prompt
        blocks = None
        cached_tokens = 0
        if self.pool is not None:
            shared: list[int] = []
            if self.prefix_cache is not None:
                # match first: the incref pins the prefix against the
                # reclaim alloc() may run to satisfy the remainder
                shared = self.prefix_cache.match(seq, req.cache_salt)
                cached_tokens = len(shared) * self.pool.block_size
            # a resumed sequence is prompt + generated so far, and its
            # remaining budget is smaller by the same amount — the block
            # need is prompt + budget either way
            need = self.pool.blocks_for(
                req.prompt_len + req.budget(self.max_len))
            while True:
                fresh = self.pool.alloc(need - len(shared))
                if fresh is not None:
                    break
                victim = self._pick_victim(req)
                if victim is None:
                    if self.prefix_cache is not None:
                        # undo the match — references AND counters: a
                        # deferred selection re-matches every tick, and
                        # only the attempt that admits may count toward
                        # hit_rate
                        self.prefix_cache.cancel(seq, shared)
                    self._deferred += 1
                    return None
                self.preempt(victim.slot, now_s)
            blocks = shared + fresh
        self.queue.pop(idx)
        slot = self.free_slots()[0]
        if resume is not None:
            del self._paused[req.request_id]
            st = resume
            st.slot = slot
            st.blocks = blocks
            self._resumes += 1
        else:
            st = RequestState(
                request=req, slot=slot, admitted_tick=self.tick,
                admitted_s=now_s, blocks=blocks,
                admission_index=self._admissions)
        self.slots[slot] = st
        self._admissions += 1
        if self.pool is not None:
            # cached prefix tokens are already written: chunked prefill
            # starts at the first uncached token (zero prefill if capped
            # only by the last-token rule). A resume replays prompt +
            # generated tokens the same way — the preemption inserted the
            # written prefix into the trie, so usually only the tail
            # block re-prefills.
            st.prefill_tokens = seq
            st.prefill_target = int(seq.shape[0])
            st.prefill_done = cached_tokens
            if resume is None:
                st.cached_tokens = cached_tokens
            self._prefill_order.append(slot)
        else:
            st.prefill_done = req.prompt_len   # one-shot admission prefill
        self.tracer.request_event(
            "resume" if resume is not None else "admit", req.request_id,
            slot=slot, cached_tokens=cached_tokens)
        return st

    # ------------------------------------------------------- preemption
    def preempt(self, slot: int, now_s: float = 0.0) -> RequestState:
        """Evict a decode-phase lane and requeue its request for resume.
        The state object survives — tokens and the sampling stream carry
        over — and the written full-block prefix (prompt + generated
        tokens; the last sampled token's KV is not written until it is
        fed) goes into the prefix trie before the block references drop,
        so the resume re-prefills only the uncached tail."""
        st = self.slots[slot]
        if st is None:
            raise ValueError(f"preempt of vacant slot {slot}")
        if st.prefilling or not st.tokens:
            raise ValueError(
                f"slot {slot} is mid-prefill — only decode-phase lanes "
                f"with at least one token can be preempted")
        self.slots[slot] = None
        st.preemptions += 1
        self._preemptions += 1
        # written-length tracking restarts at resume (prefill_done is
        # rebuilt there); a post-round lane's tracked value equals the
        # derived count anyway, so nothing is lost
        if self.pool is not None and st.blocks:
            if self.prefix_cache is not None:
                written = st.full_sequence()[:-1]
                self.prefix_cache.insert(written, st.blocks,
                                         st.request.cache_salt)
            self.pool.decref(st.blocks)
        st.blocks = None
        st.slot = -1
        self._paused[st.request.request_id] = st
        self.queue.append(st.request)
        self.tracer.request_event("preempt", st.request.request_id,
                                  slot=slot, tokens=len(st.tokens))
        return st

    # -------------------------------------------------------- deadlines
    def drop_expired(self, request: Request, now_s: float) -> RequestState:
        """Terminal-miss a request whose deadline passed before it ever
        reached the queue (the engine holds trace arrivals back; a
        saturated run can sail past a tight deadline before submit)."""
        st = RequestState(request=request, slot=-1, admitted_tick=-1,
                          admitted_s=now_s)
        st.finish_reason = "deadline_missed"
        st.finished_tick = self.tick
        st.finished_s = now_s
        self.finished.append(st)
        self._deadline_missed += 1
        # the request never reached submit(): open+close its span here so
        # the trace still shows one (zero-length) bar for it
        self.tracer.request_event("submit", request.request_id,
                                  prompt_len=request.prompt_len,
                                  priority=request.priority,
                                  deadline_s=request.deadline_s)
        self.tracer.request_event("finish", request.request_id,
                                  reason="deadline_missed", expired=True)
        return st

    def expire_deadlines(self, now_s: float) -> list[RequestState]:
        """Cancel every request whose ``deadline_s`` has passed: queued
        requests (including preempted ones awaiting resume) are dropped,
        active lanes are evicted — all with reason ``deadline_missed``.
        Returns the newly finished states so the engine can record them."""
        out: list[RequestState] = []
        keep: list[Request] = []
        for r in self.queue:
            if r.deadline_s is not None and now_s > r.deadline_s:
                st = self._paused.pop(r.request_id, None)
                if st is None:
                    st = RequestState(request=r, slot=-1, admitted_tick=-1,
                                      admitted_s=now_s)
                st.finish_reason = "deadline_missed"
                st.finished_tick = self.tick
                st.finished_s = now_s
                self.finished.append(st)
                self._deadline_missed += 1
                self.tracer.request_event("finish", r.request_id,
                                          reason="deadline_missed",
                                          queued=True)
                out.append(st)
            else:
                keep.append(r)
        self.queue = keep
        for slot, st in enumerate(self.slots):
            if (st is not None and st.request.deadline_s is not None
                    and now_s > st.request.deadline_s):
                out.append(self.evict(slot, "deadline_missed", now_s))
        return out

    # ---------------------------------------------------- chunked prefill
    def prefill_head(self) -> RequestState | None:
        """The oldest lane still mid-prefill (admission order)."""
        while self._prefill_order:
            st = self.slots[self._prefill_order[0]]
            if st is not None and st.prefilling:
                return st
            self._prefill_order.pop(0)
        return None

    def prefill_advance(self, slot: int, n_tokens: int) -> RequestState:
        st = self.slots[slot]
        if st is None:
            raise ValueError(f"prefill_advance on vacant slot {slot}")
        st.prefill_done += n_tokens
        if not st.prefilling and self._prefill_order and \
                self._prefill_order[0] == slot:
            self._prefill_order.pop(0)
        return st

    def evict(self, slot: int, reason: str, now_s: float = 0.0) -> RequestState:
        st = self.slots[slot]
        if st is None:
            raise ValueError(f"evict of vacant slot {slot}")
        st.finish_reason = reason
        st.finished_tick = self.tick
        st.finished_s = now_s
        self.slots[slot] = None
        self.finished.append(st)
        if reason == "deadline_missed":
            self._deadline_missed += 1
        else:
            self._evictions[reason] = self._evictions.get(reason, 0) + 1
        self.tracer.request_event("finish", st.request.request_id,
                                  reason=reason, slot=slot,
                                  tokens=len(st.tokens))
        if self.pool is not None and st.blocks:
            if self.prefix_cache is not None:
                # adopt the full-block prefixes before dropping references
                # (mark_cached needs them live); shared leading blocks are
                # already nodes and insert nothing. A deadline kill can
                # land mid-prefill — only the written prefix may be
                # indexed (unwritten blocks would serve garbage KV)
                if st.prefill_done < st._target:
                    seq = (st.prefill_tokens if st.prefill_tokens is not None
                           else st.request.prompt)
                    insertable = np.asarray(seq)[: st.prefill_done]
                else:
                    insertable = st.request.prompt
                self.prefix_cache.insert(insertable, st.blocks,
                                         st.request.cache_salt)
            self.pool.decref(st.blocks)
        if slot in self._prefill_order:
            self._prefill_order.remove(slot)
        return st

    # ------------------------------------------------------------ stats
    def live_tokens(self) -> int:
        """Tokens currently written into occupied lanes' caches."""
        return sum(
            s.live_kv_tokens for s in self.slots if s is not None)

    def counters(self) -> dict:
        out = {
            "admissions": self._admissions,
            "deferred_admissions": self._deferred,
            # evictions by cause, not one aggregate: normal completion
            # (by finish reason), SLO preemption (requeued, will resume)
            # and deadline expiry (terminal) are different signals
            "evictions": {
                "finished": dict(self._evictions),
                "preempted": self._preemptions,
                "deadline_missed": self._deadline_missed,
            },
            "preemptions": self._preemptions,
            "resumes": self._resumes,
            "deadline_missed": self._deadline_missed,
            "policy": self.policy.name,
            "pending": self.pending,
            "occupied": self.occupancy(),
            "ticks": self.tick,
        }
        if self.pool is not None:
            out["block_pool"] = self.pool.stats()
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out
