"""Flight recorder: bounded ring-buffer tracer with Chrome-trace export
(port of ``repro.obs.trace``).

The tracer records two families of events:

* **Phase spans** — how a tick's wall time decomposes: ``admit``,
  ``bind``, ``prefill-chunk``, ``spec-draft``, ``spec-verify``,
  ``decode``, ``sample``, ``expire``, ``reclaim``.  Each span carries a
  host timestamp pair (``clock()`` at enter/exit, default
  ``time.perf_counter``) and the engine tick it ran under.
* **Request lifecycle events** — what one request experienced:
  ``submit``, ``admit``, ``chunk``, ``first-token``, ``preempt``,
  ``resume``, ``rewind``, ``finish``.  These export as Chrome *async*
  spans so a request renders as one horizontal bar with visible gaps
  while preempted.

Design constraints (the reference's, kept):

* **Zero cost when off.**  The engine holds :data:`NULL_TRACER` unless
  the caller passes a real :class:`Tracer`.  Every ``NullTracer`` method
  returns immediately and never reads a clock, so an untraced run makes
  exactly the same clock-read sequence as a build without tracing —
  this matters under ``SimClock``, where *reading* the engine clock
  advances it.
* **The tracer never reads the engine clock.**  All tracer timestamps
  come from its own injected ``clock``; engine-time ordering is carried
  by the integer ``tick`` stamped on every event via
  :meth:`Tracer.set_tick`.
* **Bounded memory.**  Events live in a ``deque(maxlen=ring_events)``;
  old events fall off the front and are counted in ``events_dropped``.
  Per-phase *durations* are accumulated outside the ring so the
  ``timing`` summary covers the whole run even after the ring wraps.

What the port adds: **device time of device phases.**  On the card the
engine's steps are CUDA-graph replays that return once enqueued, so a host
span of ``prefill-chunk`` or ``admit`` times a launch and its device work
lands in the next span that synchronizes.  After :meth:`Tracer.time_device`
(the engine calls it when its device is CUDA) each span of a ``device``
phase also records a pair of CUDA timing events on the current
stream, and :meth:`Tracer.phase_span` takes such a pair from
:meth:`Tracer.device_mark`.  The pairs are resolved together, after one
synchronize, when :meth:`Tracer.device_durations` is read (a snapshot, the
end of a run), never per tick; each resolved span gains ``device_ms`` in
its args.  :meth:`Tracer.phase_durations` and :meth:`Tracer.phase_summary`
(the ``timing`` section) stay the host spans, as in the reference;
:meth:`Tracer.device_durations` is what the attribution ledger reads, and
without device timing (the CPU, where device time is host time) it is the
host durations themselves.  No event may be recorded while a CUDA graph is
being captured: :meth:`Tracer.device_mark` raises there.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

# Phase glossary: name -> where the time goes.  "device" phases are
# dominated by dispatched computation (the engine syncs inside decode /
# spec phases; prefill/admit spans cover dispatch of the traced step),
# "host" phases are pure Python bookkeeping.
PHASES: dict[str, str] = {
    "admit": "device",          # one-shot / draft admission prefill
    "bind": "host",             # paged slot binding + block alloc
    "prefill-chunk": "device",  # one chunked-prefill step
    "spec-draft": "device",     # draft chain proposing k tokens
    "spec-verify": "device",    # batched (slots, k+1) target verify
    "decode": "device",         # masked batched decode step
    "sample": "host",           # host-side token accept/append loop
    "expire": "host",           # deadline expiry sweep
    "reclaim": "host",          # prefix-cache LRU block reclaim
}

REQUEST_EVENTS = (
    "submit", "admit", "chunk", "first-token",
    "preempt", "resume", "rewind", "finish",
)

_US = 1e6  # seconds -> Chrome trace microseconds

# Fixed pid/tid layout for the Chrome export: pid 1 holds phase tracks
# (tid 0 = engine tick loop, tid 1+slot = per-slot work), pid 2 holds
# request async spans.
_PID_PHASES = 1
_PID_REQUESTS = 2


class _PhaseSpan:
    """Context manager recording one phase span on ``__exit__``."""

    __slots__ = ("_tr", "name", "tick", "slot", "args", "_t0", "_ev0")

    def __init__(self, tr: "Tracer", name: str, tick: int, slot, args):
        self._tr = tr
        self.name = name
        self.tick = tick
        self.slot = slot
        self.args = args
        self._t0 = 0.0
        self._ev0 = None

    def __enter__(self):
        self._t0 = self._tr._clock()
        if self._tr._device_timed(self.name):
            self._ev0 = self._tr.device_mark()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tr._end_phase(self)
        return False


class Tracer:
    """Ring-buffer event recorder with Chrome trace-event export."""

    enabled = True

    def __init__(self, ring_events: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._ring_events = int(ring_events)
        self._device: torch.device | None = None
        self.reset()

    def time_device(self, device) -> None:
        """Time the spans of ``device`` phases on ``device`` too, with CUDA
        events (a no-op unless it is a CUDA device)."""
        device = torch.device(device)
        self._device = device if device.type == "cuda" else None

    # -- recording ---------------------------------------------------

    def reset(self) -> None:
        """Drop all recorded state; t=0 becomes "now"."""
        self.events: deque = deque(maxlen=self._ring_events)
        self._durations: dict[str, list[float]] = {}
        # device phases' device seconds (None until resolved) and the
        # event pairs still to resolve: (list, index, record, start, end)
        self._device_s: dict[str, list] = {}
        self._pending: list[tuple] = []
        self._n_events = 0
        self._tick = 0
        self._t0 = self._clock()
        # async bookkeeping: which request ids have an open outer span /
        # an open "active" (admitted) span.
        self._begun: set = set()
        self._active: set = set()

    def set_tick(self, tick: int) -> None:
        """Default engine tick stamped on events that don't pass one.

        The engine calls this once per tick so deep callees (e.g. the
        prefix cache's reclaimer) don't need tick plumbing.
        """
        self._tick = tick

    @property
    def tick(self) -> int:
        return self._tick

    def phase(self, name: str, slot: int | None = None, **args) -> _PhaseSpan:
        """Span context manager: ``with tr.phase("decode"): ...``."""
        return _PhaseSpan(self, name, self._tick, slot, args or None)

    def _end_phase(self, span: _PhaseSpan) -> None:
        ev1 = None if span._ev0 is None else self.device_mark()
        t1 = self._clock()
        rec = {
            "kind": "phase", "name": span.name, "tick": span.tick,
            "slot": span.slot, "ts": span._t0 - self._t0,
            "dur": t1 - span._t0, "args": span.args,
        }
        self._push(rec)
        self._durations.setdefault(span.name, []).append(t1 - span._t0)
        if ev1 is not None:
            self._defer(span.name, rec, span._ev0, ev1)

    def phase_span(self, name: str, t_start: float, t_end: float,
                   slot: int | None = None, *, marks=None, **args) -> None:
        """Record an externally timed span.

        ``t_start``/``t_end`` must come from the same clock family as
        the tracer's clock (``time.perf_counter`` by default) — the
        engine uses this for spec draft/verify so the spans carry the
        *same* stamps that feed ``SpecStats.draft_s``/``verify_s`` and
        the two reconcile exactly.  ``marks``: the span's two
        :meth:`device_mark` events (None without device timing).
        """
        rec = {
            "kind": "phase", "name": name, "tick": self._tick,
            "slot": slot, "ts": t_start - self._t0,
            "dur": t_end - t_start, "args": args or None,
        }
        self._push(rec)
        self._durations.setdefault(name, []).append(t_end - t_start)
        if marks is not None and marks[0] is not None:
            self._defer(name, rec, *marks)

    # -- device time -------------------------------------------------

    def _device_timed(self, name: str) -> bool:
        return self._device is not None and PHASES.get(name) == "device"

    def device_mark(self):
        """A timing event recorded now on the current stream, or None
        without device timing. Raises inside a CUDA graph capture (the
        event would be captured instead of recorded)."""
        if self._device is None:
            return None
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a tracer span may not record a CUDA event "
                               "while a graph is being captured")
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def _defer(self, name: str, rec: dict, ev0, ev1) -> None:
        durs = self._device_s.setdefault(name, [])
        durs.append(None)
        self._pending.append((durs, len(durs) - 1, rec, ev0, ev1))

    def _resolve(self) -> None:
        """Read every pending event pair after one synchronize."""
        if not self._pending:
            return
        torch.cuda.synchronize(self._device)
        for durs, i, rec, ev0, ev1 in self._pending:
            s = ev0.elapsed_time(ev1) / 1e3
            durs[i] = s
            rec["args"] = {**(rec["args"] or {}), "device_ms": s * 1e3}
        self._pending = []

    def device_durations(self) -> dict[str, list[float]]:
        """Full-run per-phase durations with each device phase's device
        seconds in place of its host spans (resolving pending events):
        what the attribution ledger apportions. Without device timing,
        :meth:`phase_durations` itself."""
        if self._device is None:
            return self._durations
        self._resolve()
        return {name: self._device_s.get(name, durs)
                for name, durs in self._durations.items()}

    def instant(self, name: str, **args) -> None:
        """Point-in-time marker on the engine track (e.g. plan events)."""
        self._push({
            "kind": "instant", "name": name, "tick": self._tick,
            "slot": None, "ts": self._clock() - self._t0,
            "args": args or None,
        })

    def counter(self, name: str, values: dict) -> None:
        """Record a counter-track sample (Perfetto/Chrome "C" event).

        ``values`` maps series name -> number; successive samples of the
        same ``name`` render as stacked counter tracks (e.g. attributed
        device seconds by bound class, pool blocks in use).
        """
        self._push({
            "kind": "counter", "name": name, "tick": self._tick,
            "slot": None, "ts": self._clock() - self._t0,
            "args": {k: float(v) for k, v in values.items()},
        })

    def request_event(self, event: str, request_id, **args) -> None:
        """Record one lifecycle event for ``request_id``.

        ``submit``/``finish`` open/close the outer async span;
        ``admit``/``resume`` and ``preempt``/``finish`` open/close the
        inner "active" span, so a preempted request shows a gap between
        its active segments.  Everything else is an async instant.
        """
        ts = self._clock() - self._t0
        rec = {
            "kind": "request", "event": event, "req": request_id,
            "tick": self._tick, "ts": ts, "args": args or None,
        }
        if event == "submit":
            self._begun.add(request_id)
        elif event in ("admit", "resume"):
            self._active.add(request_id)
        elif event == "preempt":
            self._active.discard(request_id)
        elif event == "finish":
            rec["was_active"] = request_id in self._active
            rec["was_begun"] = request_id in self._begun
            self._active.discard(request_id)
            self._begun.discard(request_id)
        self._push(rec)

    def _push(self, rec: dict) -> None:
        self._n_events += 1
        self.events.append(rec)

    # -- summaries ---------------------------------------------------

    @property
    def events_dropped(self) -> int:
        return self._n_events - len(self.events)

    def phase_durations(self) -> dict[str, list[float]]:
        """Full-run per-phase duration lists (not ring-bounded)."""
        return self._durations

    def phase_summary(self) -> dict:
        """The metrics ``timing`` section: per-phase stats + host/device split.

        Percentiles are ``np.percentile`` over the complete duration
        list, so they are an exact, deterministic function of the
        recorded durations (inject a fake ``clock`` for fully
        deterministic tests).
        """
        phases = {}
        host_s = 0.0
        device_s = 0.0
        for name in sorted(self._durations):
            durs = np.asarray(self._durations[name], dtype=np.float64)
            kind = PHASES.get(name, "host")
            total = float(durs.sum())
            phases[name] = {
                "kind": kind,
                "count": int(durs.size),
                "total_s": total,
                "mean_s": float(durs.mean()),
                "p50_s": float(np.percentile(durs, 50)),
                "p99_s": float(np.percentile(durs, 99)),
            }
            if kind == "device":
                device_s += total
            else:
                host_s += total
        return {
            "phases": phases,
            "host_s": host_s,
            "device_s": device_s,
            "events_recorded": self._n_events,
            "events_dropped": self.events_dropped,
        }

    # -- Chrome trace export -----------------------------------------

    def to_chrome(self) -> dict:
        """Export the ring as a Chrome trace-event JSON object.

        Layout: pid 1 carries phase spans ("X" complete events; tid 0 is
        the engine tick loop, tid 1+slot a per-slot track), pid 2 carries
        request lifecycles as async spans — an outer ``request`` span
        (submit→finish) plus inner ``active`` spans (admit→preempt /
        resume→finish) whose gaps are the preempted stretches.
        """
        out: list[dict] = []
        tids_seen: set[int] = set()
        # Async span state replayed from the (possibly wrapped) ring:
        # req -> begin ts for outer/inner spans.
        outer_open: dict = {}
        active_open: dict = {}

        def async_ev(ph, name, req, ts, args=None):
            ev = {
                "name": name, "cat": "request", "ph": ph,
                "ts": ts * _US, "pid": _PID_REQUESTS,
                "id": str(req),
            }
            if args:
                ev["args"] = args
            out.append(ev)

        for rec in self.events:
            args = dict(rec.get("args") or {})
            if rec["tick"] is not None:
                args["tick"] = rec["tick"]
            if rec["kind"] == "phase":
                tid = 0 if rec["slot"] is None else 1 + int(rec["slot"])
                tids_seen.add(tid)
                out.append({
                    "name": rec["name"], "cat": "phase", "ph": "X",
                    "ts": rec["ts"] * _US, "dur": max(rec["dur"], 0.0) * _US,
                    "pid": _PID_PHASES, "tid": tid, "args": args,
                })
            elif rec["kind"] == "instant":
                tids_seen.add(0)
                out.append({
                    "name": rec["name"], "cat": "engine", "ph": "i",
                    "s": "t", "ts": rec["ts"] * _US,
                    "pid": _PID_PHASES, "tid": 0, "args": args,
                })
            elif rec["kind"] == "counter":
                # counter args must stay numeric series values — no tick
                tids_seen.add(0)
                out.append({
                    "name": rec["name"], "cat": "counter", "ph": "C",
                    "ts": rec["ts"] * _US,
                    "pid": _PID_PHASES, "tid": 0,
                    "args": dict(rec.get("args") or {}),
                })
            else:  # request lifecycle
                event, req, ts = rec["event"], rec["req"], rec["ts"]
                if event == "submit":
                    async_ev("b", "request", req, ts, args)
                    outer_open[req] = ts
                elif event in ("admit", "resume"):
                    async_ev("b", "active", req, ts, args)
                    active_open[req] = ts
                elif event == "preempt":
                    if req in active_open:
                        async_ev("e", "active", req, ts, args)
                        active_open.pop(req, None)
                    async_ev("n", "request", req, ts, {"event": event, **args})
                elif event == "finish":
                    if rec.get("was_active") and req in active_open:
                        async_ev("e", "active", req, ts)
                        active_open.pop(req, None)
                    if rec.get("was_begun") and req in outer_open:
                        async_ev("e", "request", req, ts, args)
                        outer_open.pop(req, None)
                    else:
                        # begin fell off the ring (or was never recorded):
                        # degrade to an async instant so the file stays
                        # balanced.
                        async_ev("n", "request", req, ts,
                                 {"event": event, **args})
                else:  # chunk / first-token / rewind / ...
                    async_ev("n", "request", req, ts, {"event": event, **args})

        # Close spans still open at export time at the last known ts so
        # viewers don't render them as unbounded.
        t_end = max((ev["ts"] for ev in out), default=0.0) / _US
        for req in list(active_open):
            async_ev("e", "active", req, t_end, {"open_at_export": True})
        for req in list(outer_open):
            async_ev("e", "request", req, t_end, {"open_at_export": True})

        meta = [
            {"name": "process_name", "ph": "M", "pid": _PID_PHASES,
             "args": {"name": "engine phases"}},
            {"name": "process_name", "ph": "M", "pid": _PID_REQUESTS,
             "args": {"name": "requests"}},
        ]
        for tid in sorted(tids_seen):
            label = "tick loop" if tid == 0 else f"slot {tid - 1}"
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": _PID_PHASES, "tid": tid,
                         "args": {"name": label}})

        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {
                "events_recorded": self._n_events,
                "events_dropped": self.events_dropped,
            },
        }

    def save(self, path) -> dict:
        """Write the Chrome trace JSON to ``path``; returns the object."""
        if self._device is not None:
            self._resolve()  # device_ms into the spans' args
        obj = self.to_chrome()
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


class NullTracer:
    """Inert tracer: every method is a no-op and no clock is ever read."""

    enabled = False

    class _NullSpan:
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, exc_type, exc, tb):
            return False

    _SPAN = _NullSpan()

    def reset(self) -> None:
        pass

    def set_tick(self, tick: int) -> None:
        pass

    def time_device(self, device) -> None:
        pass

    def device_mark(self):
        return None

    def phase(self, name: str, slot: int | None = None, **args):
        return self._SPAN

    def phase_span(self, name, t_start, t_end, slot=None, *, marks=None,
                   **args) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, values: dict) -> None:
        pass

    def request_event(self, event: str, request_id, **args) -> None:
        pass

    def phase_durations(self) -> dict:
        return {}

    def device_durations(self) -> dict:
        return {}

    def phase_summary(self) -> dict:
        return {}


NULL_TRACER = NullTracer()


def validate_chrome_trace(obj, require_phases=(), min_requests: int = 0,
                          min_preempts: int = 0) -> dict:
    """Validate a Chrome trace-event JSON object; raise ``ValueError``.

    Checks structural well-formedness (every event has name/ph/ts; "X"
    events have a non-negative ``dur``; async begin/end balance per
    ``(id, name)``), then the content floor: every phase named in
    ``require_phases`` has at least one span, at least ``min_requests``
    distinct requests have a complete submit→finish span, and at least
    ``min_preempts`` preempt markers are present.  Returns a summary
    dict (phase span counts, request count, preempt count).
    """
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: top-level 'traceEvents' list missing")
    phase_spans: dict[str, int] = {}
    async_depth: dict[tuple, int] = {}
    completed_requests: set = set()
    preempts = 0
    counter_samples = 0
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str) or ph is None:
            raise ValueError(f"event {i} missing name/ph")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"event {i} ({ev['name']!r}) missing numeric ts")
        if ph == "C":
            vals = ev.get("args")
            if not isinstance(vals, dict) or not all(
                    isinstance(v, (int, float)) for v in vals.values()):
                raise ValueError(
                    f"counter event {i} ({ev['name']!r}) args must be "
                    f"numeric series values: {vals!r}")
            counter_samples += 1
        elif ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} ({ev['name']!r}) bad dur: {dur!r}")
            if ev.get("cat") == "phase":
                phase_spans[ev["name"]] = phase_spans.get(ev["name"], 0) + 1
        elif ph in ("b", "e", "n"):
            if "id" not in ev:
                raise ValueError(f"async event {i} ({ev['name']!r}) missing id")
            key = (ev["id"], ev["name"])
            if ph == "b":
                async_depth[key] = async_depth.get(key, 0) + 1
            elif ph == "e":
                depth = async_depth.get(key, 0)
                if depth <= 0:
                    raise ValueError(
                        f"async end without begin for id={ev['id']!r} "
                        f"name={ev['name']!r}")
                async_depth[key] = depth - 1
                if ev["name"] == "request":
                    completed_requests.add(ev["id"])
            else:
                if (ev.get("args") or {}).get("event") == "preempt":
                    preempts += 1
    unbalanced = {k: d for k, d in async_depth.items() if d != 0}
    if unbalanced:
        raise ValueError(f"unbalanced async spans: {sorted(unbalanced)[:5]}")
    missing = [p for p in require_phases if phase_spans.get(p, 0) < 1]
    if missing:
        raise ValueError(
            f"required phases with no spans: {missing} "
            f"(present: {sorted(phase_spans)})")
    if len(completed_requests) < min_requests:
        raise ValueError(
            f"only {len(completed_requests)} completed request spans, "
            f"need >= {min_requests}")
    if preempts < min_preempts:
        raise ValueError(f"only {preempts} preempt markers, need >= {min_preempts}")
    return {
        "events": len(obj["traceEvents"]),
        "phase_spans": phase_spans,
        "completed_requests": len(completed_requests),
        "preempts": preempts,
        "counter_samples": counter_samples,
    }
