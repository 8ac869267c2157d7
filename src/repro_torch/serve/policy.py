"""SLO-aware scheduling policies: admission ordering, preemption ranking,
and the feedback-driven prefill/decode budget.

The scheduler (`serve/scheduler.py`) delegates two decisions to a policy
object, both pure host-side Python:

* **select** — which queued request to try admitting next. FIFO picks the
  head; priority picks the highest ``Request.priority`` (ties in arrival
  order, so equal-priority traffic keeps the no-starvation FIFO
  guarantee); EDF picks the earliest ``deadline_s`` (deadline-less
  requests sort last); prefix-affinity picks the request whose prompt has
  the longest cached prefix in the radix trie (maximizing skipped prefill
  per admission).
* **victim** — which running decode lane to preempt when the selected
  request cannot get a lane or its KV blocks. Only *strictly less
  urgent* lanes are eligible — urgency is the rank's primary component
  (priority / deadline) without the FIFO tie-breaks, so an equal-priority
  arrival can never evict an equal-priority lane and admit→preempt
  cycles are impossible — and only lanes past prefill with at least one
  generated token (a mid-prefill eviction would waste the chunks already
  paid for). FIFO and prefix-affinity are non-preemptive and always
  return None.

Ordering is expressed through ``rank(request)`` (full sort key, smaller
is more urgent; drives select) and ``urgency(request)`` (its primary
component; drives victim eligibility) — so select and victim can't
disagree about who matters.

The **budget controller** closes the ROADMAP's feedback loop: the paged
engine interleaves chunked prefill with decode, and the number of prefill
chunks it runs per tick is the knob that trades TTFT (prefill latency)
against decode throughput. ``BudgetController`` adapts that knob from
observed submit→first-token latency against ``--ttft-target-ms``:
additive-increase when the EWMA misses the target (drain the queue
faster), additive-decrease when it beats it (give ticks back to decode).
Every chunk still pads to one of the warm bucket signatures, so the
zero-lazy-solve steady state is untouched — the controller only changes
*how many* warm calls a tick issues.

``SimClock`` is the deterministic test/benchmark clock: each reading
advances a fixed ``dt``, so TTFT, deadlines and burst arrivals are exact
functions of the event sequence — no wall-clock flakiness in the
scheduler tests or the SLO benchmark.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:  # import cycle guard: scheduler imports policy
    from repro_torch.serve.prefixcache import PrefixCache
    from repro_torch.serve.request import Request, RequestState


class SchedPolicy:
    """Base admission policy: FIFO order, no preemption."""

    name = "fifo"
    preemptive = False

    def rank(self, request: "Request") -> tuple:
        """Sort key — smaller is admitted sooner. Arrival order breaks
        every tie, so equal-rank requests are FIFO among themselves."""
        return (request.arrival_tick, request.request_id)

    def urgency(self, request: "Request"):
        """The preemption key: rank's primary component WITHOUT the
        arrival/id tie-breaks. Victim eligibility compares urgency, not
        rank — otherwise an equal-priority (or equal-deadline) arrival
        could preempt a running lane purely on the FIFO tie-break:
        eviction churn with zero SLO gain. The base policy's constant
        urgency makes every lane ineligible (non-preemptive)."""
        return 0

    def select(self, queue: Sequence["Request"], *, now_s: float = 0.0,
               prefix_cache: "PrefixCache | None" = None) -> int:
        """Index of the queue entry to try admitting next."""
        if not queue:
            raise ValueError("select on an empty queue")
        return min(range(len(queue)), key=lambda i: self.rank(queue[i]))

    def victim(self, candidate: "Request",
               lanes: Sequence["RequestState"]) -> "RequestState | None":
        """The running lane to preempt so ``candidate`` can admit, or
        None. Only decode-phase lanes strictly less urgent than the
        candidate qualify; among those, the least urgent goes first and
        the most recent admission breaks ties (LIFO preemption: the lane
        with the least sunk work is evicted)."""
        if not self.preemptive:
            return None
        cand_urgency = self.urgency(candidate)
        eligible = [st for st in lanes
                    if not st.prefilling and st.tokens
                    and self.urgency(st.request) > cand_urgency]
        if not eligible:
            return None
        return max(eligible, key=lambda st: (self.urgency(st.request),
                                             st.admission_index))


class FifoPolicy(SchedPolicy):
    name = "fifo"


class PriorityPolicy(SchedPolicy):
    """Highest ``Request.priority`` first (bigger number = more
    important); preempts strictly lower-priority decodes under
    lane/block pressure."""

    name = "priority"
    preemptive = True

    def rank(self, request: "Request") -> tuple:
        return (-request.priority, request.arrival_tick, request.request_id)

    def urgency(self, request: "Request"):
        return -request.priority


class EdfPolicy(SchedPolicy):
    """Earliest-deadline-first; requests without a deadline sort after
    every deadlined one. Preempts lanes whose deadline is strictly
    later."""

    name = "edf"
    preemptive = True

    def rank(self, request: "Request") -> tuple:
        d = request.deadline_s if request.deadline_s is not None else math.inf
        return (d, request.arrival_tick, request.request_id)

    def urgency(self, request: "Request"):
        return (request.deadline_s if request.deadline_s is not None
                else math.inf)


class PrefixAffinityPolicy(SchedPolicy):
    """Longest cached prompt prefix first: admitting the best trie hit
    skips the most prefill GEMMs per admission.
    Falls back to arrival order with no cache or no hits; never
    preempts (affinity is a throughput heuristic, not an SLO)."""

    name = "prefix"

    def select(self, queue: Sequence["Request"], *, now_s: float = 0.0,
               prefix_cache: "PrefixCache | None" = None) -> int:
        if not queue:
            raise ValueError("select on an empty queue")
        if prefix_cache is None:
            return super().select(queue, now_s=now_s)
        return min(
            range(len(queue)),
            key=lambda i: (-prefix_cache.peek(queue[i].prompt,
                                              queue[i].cache_salt),
                           self.rank(queue[i])))


POLICIES = {p.name: p for p in
            (FifoPolicy, PriorityPolicy, EdfPolicy, PrefixAffinityPolicy)}


def get_policy(policy: "str | SchedPolicy | None") -> SchedPolicy:
    """Resolve a policy name (``--sched-policy``) or pass an instance
    through; None means FIFO."""
    if policy is None:
        return FifoPolicy()
    if isinstance(policy, SchedPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r} "
            f"(known: {', '.join(sorted(POLICIES))})") from None


# --------------------------------------------------------------- budget
class BudgetController:
    """Dynamic prefill/decode token budget: adapt the number of prefill
    chunks the engine runs per tick from observed TTFT vs a target.

    Additive increase / additive decrease on an exponentially-weighted
    moving average of submit→first-token latency: above target, spend
    more of each tick on prefill (queue drains faster, TTFT falls);
    below, give the ticks back to decode throughput. ``target_ttft_s``
    None pins the budget at ``min_chunks`` — exactly the pre-SLO engine
    behavior (one chunk per tick).
    """

    def __init__(self, target_ttft_s: float | None, *,
                 min_chunks: int = 1, max_chunks: int = 4,
                 ema_alpha: float = 0.3):
        if min_chunks < 1 or max_chunks < min_chunks:
            raise ValueError(
                f"need 1 <= min_chunks <= max_chunks, got "
                f"{min_chunks}/{max_chunks}")
        if target_ttft_s is not None and target_ttft_s <= 0:
            raise ValueError(f"target_ttft_s must be > 0, got {target_ttft_s}")
        self.target_ttft_s = target_ttft_s
        self.min_chunks = min_chunks
        self.max_chunks = max_chunks
        self.ema_alpha = ema_alpha
        self.level = min_chunks
        self.ema_ttft_s: float | None = None
        self.observations = 0
        self.raises = 0
        self.drops = 0

    def observe_ttft(self, ttft_s: float) -> None:
        """Feed one submit→first-token measurement; may move the level."""
        self.observations += 1
        self.ema_ttft_s = (
            ttft_s if self.ema_ttft_s is None
            else self.ema_alpha * ttft_s
            + (1 - self.ema_alpha) * self.ema_ttft_s)
        if self.target_ttft_s is None:
            return
        if self.ema_ttft_s > self.target_ttft_s:
            if self.level < self.max_chunks:
                self.level += 1
                self.raises += 1
        elif self.level > self.min_chunks:
            self.level -= 1
            self.drops += 1

    def chunks_per_tick(self) -> int:
        return self.level

    def stats(self) -> dict:
        return {
            "target_ttft_s": self.target_ttft_s,
            "min_chunks": self.min_chunks,
            "max_chunks": self.max_chunks,
            "final_chunks": self.level,
            "raises": self.raises,
            "drops": self.drops,
            "observations": self.observations,
            "ema_ttft_s": self.ema_ttft_s,
        }


# ---------------------------------------------------------------- clock
class SimClock:
    """Deterministic engine clock: every reading advances ``dt`` seconds.

    Injected as ``ServeEngine(clock=...)`` (or used directly in scheduler
    tests), it makes TTFT percentiles, burst arrivals, deadline expiry
    and the budget controller's feedback exact functions of the event
    sequence — the harness the SLO tests and the FIFO-vs-EDF benchmark
    comparison run under.
    """

    def __init__(self, dt: float = 1e-3, start: float = 0.0):
        if dt <= 0:
            raise ValueError(f"dt must be > 0, got {dt}")
        self.dt = dt
        self.now = start

    def __call__(self) -> float:
        self.now += self.dt
        return self.now
