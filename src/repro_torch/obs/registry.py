"""Counter/gauge/histogram registry with Prometheus text exposition (the
port's own copy of ``repro.obs.registry``).

The engine's subsystems each grew their own ad-hoc counters (block
pool, prefix cache, plan cache, SpecStats, budget controller).  The
registry gives them one shared home with a uniform naming scheme
(``repro_<subsystem>_<metric>``, see docs/observability.md) without
changing any existing `to_dict` schema: subsystem stat dicts are
*mirrored* into the registry via :meth:`Registry.ingest`, which
flattens nested mappings and publishes numeric leaves as gauges.

Gauges (not monotonic counters) are deliberately the default for
mirrored values: the engine re-publishes absolute totals every
snapshot interval and after ``reset()``, and a gauge ``set`` is
idempotent across engine resets where a counter's monotonicity
contract would be violated.
"""
from __future__ import annotations

import re

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")

# Exponential seconds buckets spanning sub-microsecond host phases to
# multi-second device phases.
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def prom_name(name: str) -> str:
    """Sanitize ``name`` into a valid Prometheus metric name."""
    name = _INVALID.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


class Counter:
    """Monotonically non-decreasing value."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n

    def collect(self) -> float:
        return self.value


class Gauge:
    """Value that can go up or down."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def collect(self) -> float:
        return self.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> list[tuple[str, int]]:
        """Cumulative ``(le_label, count)`` pairs ending with ``+Inf``.

        The single source of bucket truth for both the text exposition
        and JSON snapshots — Prometheus histogram buckets are cumulative
        (each ``le`` counts every observation ≤ its edge) and the
        ``+Inf`` bucket must equal ``count``.
        """
        out = []
        cum = 0
        for edge, c in zip(self.buckets, self.counts):
            cum += c
            out.append((f"{edge:g}", cum))
        out.append(("+Inf", self.count))
        return out

    def collect(self) -> dict:
        return {"buckets": dict(self.cumulative()),
                "sum": self.sum, "count": self.count}


class Registry:
    """Named metric registry with snapshots and text exposition."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self.snapshots: list[dict] = []

    def _get_or_create(self, cls, name: str, help: str, **kw):
        name = prom_name(name)
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def ingest(self, prefix: str, mapping: dict, help: str = "") -> int:
        """Mirror a (possibly nested) stats dict into gauges.

        Keys are joined with ``_`` under ``repro_<prefix>_``; numeric
        leaves become gauge sets, everything else (strings, None) is
        skipped.  Returns the number of gauges set.
        """
        n = 0
        for key, value in mapping.items():
            name = f"{prefix}_{key}"
            if isinstance(value, dict):
                n += self.ingest(name, value, help)
            elif isinstance(value, bool):
                self.gauge(f"repro_{name}", help).set(1.0 if value else 0.0)
                n += 1
            elif isinstance(value, (int, float)):
                self.gauge(f"repro_{name}", help).set(float(value))
                n += 1
        return n

    def collect(self) -> dict:
        """Flat ``{name: value}`` view (histograms as nested dicts)."""
        return {name: m.collect() for name, m in sorted(self._metrics.items())}

    def snapshot(self, tick: int | None = None) -> dict:
        """Append and return a point-in-time copy of all metrics.

        Histograms keep their full cumulative bucket vector (JSON-friendly
        string ``le`` labels) rather than collapsing to a bare sum/count
        pair — a snapshot must round-trip to the same distribution a
        scraper would see in the text exposition.
        """
        snap = {"tick": tick}
        for name, m in sorted(self._metrics.items()):
            if m.kind == "histogram":
                snap[name] = {"sum": m.sum, "count": m.count,
                              "buckets": dict(m.cumulative())}
            else:
                snap[name] = m.value
        self.snapshots.append(snap)
        return snap

    def to_prometheus_text(self) -> str:
        """Render all metrics in the Prometheus text exposition format.

        Histograms emit the full cumulative series — one
        ``_bucket{le="..."}`` line per edge plus ``+Inf``, ``_sum`` and
        ``_count`` — which is what scrapers require (a collapsed single
        value is rejected as a malformed histogram).
        """
        def esc(s: str) -> str:
            return s.replace("\\", r"\\").replace("\n", r"\n")

        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {esc(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            if m.kind == "histogram":
                for le, cum in m.cumulative():
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
            else:
                v = m.value
                lines.append(f"{name} {int(v) if float(v).is_integer() else v}")
        return "\n".join(lines) + "\n"
