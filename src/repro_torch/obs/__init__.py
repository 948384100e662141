"""Runtime observability, a copy of ``repro/obs`` (the port imports
nothing of ``repro``). All host-side:

  metrics.py    process-wide :class:`MetricsRegistry` — counters, gauges,
                fixed-bucket histograms with quantile estimation; labeled
                series keyed by plain tuples (no string formatting on the
                hot path); ``snapshot()`` for tests.
  tracing.py    :class:`SpanTracer` — nested host spans + instant events
                into a fixed ring buffer; exports Chrome ``trace_event``
                JSON and step-bucketed records into a sink.
  exporters.py  Prometheus text-exposition snapshot file (atomic
                replace) + JSONL snapshot appender.

Observability is **opt-in and process-wide**: everything starts disabled
and every instrumented call site costs one attribute test until
:func:`enable` is called. In the port, the serving engine
(``serve/engine.py`` — TTFT/ITL/queue-wait/E2E histograms, pool and slot
gauges, admission counters, admit and decode-step spans), the trainer
(``train/loop.py`` — the data-wait / dispatch / host-sync spans and
``train_*_seconds`` histograms), the checkpoints (``train/checkpoint.py``)
and the resilience ladder (``train/resilience.py``) are instrumented.

Typical use::

    from repro_torch import obs
    obs.enable()
    ... run ...
    obs.write_prometheus("metrics.prom")
    obs.write_chrome_trace("trace.json")
    snap = obs.registry().snapshot()
"""
from __future__ import annotations

from .exporters import (JSONLExporter, PrometheusExporter,
                        prometheus_exposition)
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, registry)
from .tracing import SpanTracer, tracer

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "SpanTracer", "PrometheusExporter", "JSONLExporter",
    "prometheus_exposition", "registry", "tracer",
    "enable", "disable", "enabled", "reset",
    "write_prometheus", "write_chrome_trace",
]


def enable() -> None:
    """Turn on the process-wide registry and tracer."""
    registry().enable()
    tracer().enabled = True


def disable() -> None:
    """Turn off both; instrumented sites fall back to the no-op path."""
    registry().disable()
    tracer().enabled = False


def enabled() -> bool:
    return registry().enabled


def reset() -> None:
    """Clear every recorded series and the span ring (instruments stay
    registered; the enabled state is unchanged)."""
    registry().reset()
    tracer().clear()


def write_prometheus(path: str) -> str:
    """Snapshot the default registry as a Prometheus text file."""
    return PrometheusExporter(registry(), path).write()


def write_chrome_trace(path: str) -> str:
    """Dump the default tracer's ring as Chrome ``trace_event`` JSON."""
    return tracer().write_chrome_trace(path)
