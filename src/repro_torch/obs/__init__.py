"""Observability (port of ``repro.obs``), off by default.

* ``trace`` — the flight recorder: a bounded ring-buffer tracer of
  per-tick phase spans and per-request lifecycle events with Chrome
  trace-event export (Perfetto, ``chrome://tracing``); on the card the
  device phases' spans also carry their device time (CUDA events).
* ``registry`` — a counter/gauge/histogram registry with Prometheus text
  exposition and periodic snapshots, onto which the engine publishes its
  subsystems' counters.
* ``attrib`` — the balance auditor: per GEMM signature, the traced device
  seconds against the analytic model (compute-bound, memory-bound or
  drifted; the metrics JSON's ``attribution`` section).

The engine holds ``NULL_TRACER`` unless given a tracer: its methods are
no-ops that read no clock, so an untraced run is the same run.
"""
from repro_torch.obs.attrib import GEMM_PHASES, AttributionLedger
from repro_torch.obs.registry import (Counter, Gauge, Histogram, Registry,
                                      prom_name)
from repro_torch.obs.trace import (NULL_TRACER, PHASES, NullTracer, Tracer,
                                   validate_chrome_trace)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "PHASES",
    "validate_chrome_trace",
    "Registry", "Counter", "Gauge", "Histogram", "prom_name",
    "AttributionLedger", "GEMM_PHASES",
]
