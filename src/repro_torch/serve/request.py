"""Request lifecycle records for the continuous-batching engine.

A :class:`Request` is what a client submits (prompt, generation budget, stop
ids); a :class:`RequestState` is the engine's host-side bookkeeping for it —
which slot lane it occupies, its per-request token buffer, and the tick/wall
timestamps the metrics layer turns into TTFT and per-token latency. Both are
plain Python (numpy): the device only ever sees fixed-shape slot tensors,
never a request object. Port of ``repro.serve.request`` without the
speculative-decoding pieces (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request as submitted.

    ``prompt`` is a 1-D int32 token array; ``max_new_tokens`` bounds the
    generation; any token in ``stop_ids`` ends it early (the stop token is
    kept in the output, vLLM-style). ``arrival_tick`` is stamped by the
    scheduler at submit time.

    Sampling: ``temperature``/``top_p`` override the engine-level defaults
    when set (``temperature=0`` is greedy); ``seed`` pins the request's
    sampling stream — unset, the engine derives one from its own seed and
    the request's admission index, so a fixed trace replays token-for-token
    either way.

    ``cache_salt`` namespaces the prompt-prefix cache: requests only ever
    share cached KV blocks with requests carrying the same salt, so a
    unique salt opts a request (or tenant) out of cross-request sharing
    entirely. ``None`` (default) is the common shared namespace.

    SLO fields: ``priority`` ranks requests for the priority admission
    policy (**higher is more important**; default 0); ``deadline_s`` is an
    absolute completion deadline on the engine clock — EDF admission
    orders by it, and the scheduler's deadline sweep cancels requests
    (queued or mid-decode) once it passes. ``arrival_s`` is trace
    metadata: the engine submits the request once its clock reaches it
    (0.0 = immediately), which is what makes bursty traces bursty.
    """

    prompt: np.ndarray
    max_new_tokens: int
    stop_ids: tuple[int, ...] = ()
    temperature: float | None = None
    top_p: float | None = None
    seed: int | None = None
    cache_salt: str | int | None = None
    priority: int = 0
    deadline_s: float | None = None
    arrival_s: float = 0.0
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    arrival_tick: int = -1
    submitted_s: float = 0.0          # stamped by the scheduler at submit

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.stop_ids = tuple(int(s) for s in self.stop_ids)

    def validate(self, now_s: float = 0.0) -> None:
        """Submit-time validation (scheduler.submit): reject out-of-range
        sampling knobs and already-expired deadlines with a clear error
        instead of a silent misbehavior deep in the engine."""
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.request_id}: max_new_tokens must be >= 1, "
                f"got {self.max_new_tokens}")
        if self.top_p is not None and not (0.0 < self.top_p <= 1.0):
            raise ValueError(
                f"request {self.request_id}: top_p must be in (0, 1], got "
                f"{self.top_p}")
        if self.temperature is not None and self.temperature < 0.0:
            raise ValueError(
                f"request {self.request_id}: temperature must be >= 0, got "
                f"{self.temperature}")
        if self.deadline_s is not None and self.deadline_s <= now_s:
            raise ValueError(
                f"request {self.request_id}: deadline_s={self.deadline_s} "
                f"is not in the future (now={now_s}) — it could never be "
                f"met")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def budget(self, max_len: int) -> int:
        """Effective generation budget against a ``max_len`` cache: the
        request's ask clamped to its decode headroom. The single source of
        truth — the scheduler sizes the request's KV block allocation from
        it and the engine stops decoding at it, so an admitted request can
        never write past the blocks it owns."""
        return min(self.max_new_tokens, max_len - self.prompt_len)


@dataclasses.dataclass
class RequestState:
    """Engine-side state of an admitted (or finished) request.

    Paged-engine extras: ``blocks`` is the ordered list of KV pool blocks
    the allocator assigned at admission (freed at eviction);
    ``prefill_done`` counts prompt tokens already written by chunked
    prefill — the lane joins the decode mask once it reaches
    ``prefill_target``. ``rng`` is the per-request sampling stream (host
    numpy; the device never sees randomness).

    Preemption extras: a preempted request keeps its state object across
    the evict/requeue/resume cycle — ``tokens`` and ``rng`` carry over, so
    the resumed stream continues token-for-token. On (re)admission the
    scheduler snapshots ``prefill_tokens`` (prompt + tokens generated
    before the preemption) and ``prefill_target`` (its length): chunked
    prefill replays that sequence — minus whatever prefix the radix trie
    still holds — and the final chunk's logits yield the *next* token.
    """

    request: Request
    slot: int                      # decode lane while active, last lane after
    admitted_tick: int
    admitted_s: float              # wall clock at admission (perf_counter)
    tokens: list[int] = dataclasses.field(default_factory=list)
    first_token_s: float | None = None   # wall clock of the first token
    first_token_tick: int | None = None
    finished_s: float | None = None
    finished_tick: int | None = None
    finish_reason: str | None = None     # 'stop' | 'length' |
                                         # 'deadline_missed' | None (active)
    blocks: list[int] | None = None      # paged KV pool blocks (in order)
    prefill_done: int = 0                # sequence tokens written so far
    prefill_target: int = -1             # tokens to prefill this admission
                                         # (-1: prompt_len, i.e. no resume)
    prefill_tokens: np.ndarray | None = dataclasses.field(
        default=None, repr=False)        # sequence snapshot for prefill
    cached_tokens: int = 0               # prompt tokens served by the
                                         # prefix cache (never prefilled)
    preemptions: int = 0                 # times evicted-and-requeued
    admission_index: int = -1            # nth admission of this engine run
    rng: np.random.Generator | None = dataclasses.field(
        default=None, repr=False)

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def _target(self) -> int:
        return (self.prefill_target if self.prefill_target >= 0
                else self.request.prompt_len)

    @property
    def prefilling(self) -> bool:
        return (self.finish_reason is None
                and self.prefill_done < self._target)

    @property
    def resumed_tokens(self) -> int:
        """Tokens generated before the last preemption (part of the
        prefill sequence, not re-generated)."""
        return max(0, self._target - self.request.prompt_len)

    @property
    def live_kv_tokens(self) -> int:
        """Tokens written into this lane's KV (prefill progress plus
        decode tokens generated since the last (re)admission)."""
        return self.prefill_done + max(0, len(self.tokens)
                                       - self.resumed_tokens)

    def full_sequence(self) -> np.ndarray:
        """prompt + every token generated so far — the sequence a resume
        must replay (its KV minus the still-cached prefix)."""
        return np.concatenate([
            self.request.prompt,
            np.asarray(self.tokens, np.int32)]).astype(np.int32)

    def append(self, token: int, now_s: float,
               tick: int | None = None) -> None:
        if self.first_token_s is None:
            self.first_token_s = now_s
            self.first_token_tick = tick
        self.tokens.append(int(token))

    def should_stop(self) -> str | None:
        """Finish reason implied by the current token buffer, else None."""
        if self.tokens and self.tokens[-1] in self.request.stop_ids:
            return "stop"
        if len(self.tokens) >= self.request.max_new_tokens:
            return "length"
        return None


def synthetic_trace(
    n_requests: int,
    *,
    vocab_size: int,
    prompt_lens: Sequence[int],
    max_new_tokens: Sequence[int],
    stop_ids: tuple[int, ...] = (),
    seed: int = 0,
) -> list[Request]:
    """A mixed-length request trace (benchmarks, smoke runs, tests).

    Prompt lengths and generation budgets cycle through the given sequences,
    so the mix is deterministic for a seed while still exercising uneven
    lifetimes — the traffic shape static batching handles worst.
    """
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        plen = int(prompt_lens[i % len(prompt_lens)])
        out.append(Request(
            prompt=rng.integers(0, vocab_size, size=plen, dtype=np.int32),
            max_new_tokens=int(max_new_tokens[i % len(max_new_tokens)]),
            stop_ids=stop_ids,
        ))
    return out


def shared_prefix_trace(
    n_requests: int,
    *,
    vocab_size: int,
    header_len: int,
    tail_lens: Sequence[int],
    max_new_tokens: Sequence[int],
    stop_ids: tuple[int, ...] = (),
    seed: int = 0,
) -> list[Request]:
    """A trace where every request repeats one ``header_len``-token header
    (system prompt / few-shot block) followed by a per-request random tail
    — the traffic shape the prefix cache (serve/prefixcache.py) exists
    for. Prompts are pairwise distinct (tails are independent draws), so
    output parity vs a cache-off run is checkable per request."""
    rng = np.random.default_rng(seed)
    header = rng.integers(0, vocab_size, size=header_len, dtype=np.int32)
    out = []
    for i in range(n_requests):
        tail = rng.integers(
            0, vocab_size, size=int(tail_lens[i % len(tail_lens)]),
            dtype=np.int32)
        out.append(Request(
            prompt=np.concatenate([header, tail]),
            max_new_tokens=int(max_new_tokens[i % len(max_new_tokens)]),
            stop_ids=stop_ids,
        ))
    return out


def bursty_trace(
    n_requests: int,
    *,
    vocab_size: int,
    burst_size: int = 4,
    burst_gap_s: float = 0.05,
    classes: Sequence[dict] | None = None,
    header_len: int = 0,
    stop_ids: tuple[int, ...] = (),
    seed: int = 0,
) -> list[Request]:
    """A seeded bursty mixed-priority trace for the SLO scheduler.

    Requests arrive in bursts of ``burst_size`` spaced ``burst_gap_s``
    apart on the engine clock (``Request.arrival_s``; the engine holds a
    request back until its clock reaches it). Each request draws a
    priority *class* — a dict of ``{priority, prompt_lens,
    max_new_tokens, deadline_slack_s, weight}`` — so interactive traffic
    (high priority, short prompts, tight deadlines) and background
    traffic (low priority, long prompts, loose/no deadlines) interleave
    in one queue. ``deadline_slack_s`` is added to the arrival time to
    form the absolute ``deadline_s`` (None = no deadline). With
    ``header_len > 0`` every prompt shares one leading header, so the
    prefix-affinity policy and the preempt-to-trie resume path have
    prefixes to work with. Deterministic for a seed.
    """
    if classes is None:
        classes = [
            dict(priority=2, prompt_lens=(6, 8), max_new_tokens=(4, 6),
                 deadline_slack_s=0.5, weight=1.0),
            dict(priority=0, prompt_lens=(16, 24), max_new_tokens=(16, 24),
                 deadline_slack_s=None, weight=1.0),
        ]
    rng = np.random.default_rng(seed)
    weights = np.asarray([float(c.get("weight", 1.0)) for c in classes])
    weights = weights / weights.sum()
    header = (rng.integers(0, vocab_size, size=header_len, dtype=np.int32)
              if header_len else None)
    out = []
    for i in range(n_requests):
        arrival = (i // burst_size) * burst_gap_s
        c = classes[int(rng.choice(len(classes), p=weights))]
        plens = c["prompt_lens"]
        gens = c["max_new_tokens"]
        plen = int(plens[int(rng.integers(len(plens)))])
        tail = rng.integers(0, vocab_size, size=plen, dtype=np.int32)
        prompt = tail if header is None else np.concatenate([header, tail])
        slack = c.get("deadline_slack_s")
        out.append(Request(
            prompt=prompt,
            max_new_tokens=int(gens[int(rng.integers(len(gens)))]),
            stop_ids=stop_ids,
            priority=int(c.get("priority", 0)),
            deadline_s=(None if slack is None else arrival + float(slack)),
            arrival_s=arrival,
        ))
    return out
