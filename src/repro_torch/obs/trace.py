"""The inert tracer (port of ``repro.obs.trace.NullTracer``).

The serving engine, scheduler and prefix cache call tracer hooks at every
phase and request event; ``NULL_TRACER`` makes each a no-op that reads no
clock. The flight recorder itself (``Tracer``: phase spans, Chrome trace
export) is ROADMAP queue 1, item 8.
"""
from __future__ import annotations


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

    def phase(self, name: str, slot: int | None = None, **args):
        return self._SPAN

    def request_event(self, event: str, request_id, **args) -> None:
        pass


NULL_TRACER = NullTracer()
