"""Observability (port of ``repro.obs``): only the inert tracer so far."""
