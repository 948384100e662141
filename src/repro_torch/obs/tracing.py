"""Span tracer: nested host-side spans into a fixed-size ring buffer.

A copy of ``repro/obs/tracing.py`` (the port imports nothing of
``repro``).

A *span* is one timed region of host code (a decode step, a prefill, a
checkpoint write, a train-loop phase); spans nest through a per-thread
stack, so a ``ckpt/write`` span opened inside a ``train/step`` span
records its parent depth. An *event* is a zero-duration instant (a guard
trip, a rank reallocation) carrying structured args.

The buffer is a preallocated list written by a monotonically increasing
cursor (index = ``seq % capacity``) — append is one slot store + one
integer increment, no locking on the hot path (CPython's atomic list
item assignment is sufficient for single-writer-per-thread use; the
cursor is guarded only when exporting). When the tracer is disabled,
``span`` returns a shared no-op context manager and ``instant`` returns
immediately, so the cost of *compiled-in* instrumentation is one
attribute test.

Exports:

  * :meth:`SpanTracer.chrome_trace` / :meth:`write_chrome_trace` — the
    Chrome ``trace_event`` JSON format (load in ``chrome://tracing`` or
    Perfetto): complete ``"X"`` events with microsecond ``ts``/``dur``,
    instants as ``"i"`` events.
  * :meth:`SpanTracer.to_sink` — step-bucketed records into any sink
    with a ``log_metrics(record)`` method (the JAX package's
    ``TelemetrySink``; the port has no telemetry sink yet): span
    durations become ``span/<name>`` fields of per-step records.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Optional


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live span handle; records on ``__exit__``."""

    __slots__ = ("tracer", "name", "cat", "step", "args", "t0", "depth")

    def __init__(self, tracer, name, cat, step, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.step = step
        self.args = args

    def __enter__(self):
        tls = self.tracer._tls
        self.depth = getattr(tls, "depth", 0)
        tls.depth = self.depth + 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        self.tracer._tls.depth = self.depth
        self.tracer._record({
            "ph": "X", "name": self.name, "cat": self.cat,
            "ts": self.t0, "dur": dur, "depth": self.depth,
            "tid": threading.get_ident(), "step": self.step,
            "args": self.args,
        })
        return False


class SpanTracer:
    """Ring buffer of spans/instants with Chrome-trace and sink export."""

    def __init__(self, capacity: int = 4096, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self._buf: list[Optional[dict]] = [None] * capacity
        self._seq = 0                        # total records ever written
        self._tls = threading.local()
        self._lock = threading.Lock()        # export-time consistency only

    # -- recording ----------------------------------------------------------
    def _record(self, rec: dict) -> None:
        seq = self._seq
        self._buf[seq % self.capacity] = rec
        self._seq = seq + 1

    def span(self, name: str, *, cat: str = "host",
             step: Optional[int] = None, **args):
        """``with tracer.span("serve/decode", step=i): ...`` — times the
        block and records it (nested spans record their depth)."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, step, args or None)

    def instant(self, name: str, *, cat: str = "event",
                step: Optional[int] = None, **args) -> None:
        """Zero-duration structured event (ladder decisions, controller
        re-allocations, admissions)."""
        if not self.enabled:
            return
        self._record({
            "ph": "i", "name": name, "cat": cat,
            "ts": time.perf_counter_ns(), "dur": 0, "depth": 0,
            "tid": threading.get_ident(), "step": step,
            "args": args or None,
        })

    # -- reads --------------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Records overwritten by ring wraparound since construction."""
        return max(0, self._seq - self.capacity)

    def records(self) -> list[dict]:
        """Retained records, oldest first (at most ``capacity``)."""
        with self._lock:
            seq = self._seq
            if seq <= self.capacity:
                return [r for r in self._buf[:seq]]
            cut = seq % self.capacity
            return self._buf[cut:] + self._buf[:cut]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._seq = 0

    # -- exports ------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The retained buffer as a Chrome ``trace_event`` object
        (``ts``/``dur`` in microseconds, as the format requires)."""
        events = []
        for r in self.records():
            ev = {
                "name": r["name"], "cat": r["cat"], "ph": r["ph"],
                "ts": r["ts"] / 1e3, "pid": 0, "tid": r["tid"],
            }
            if r["ph"] == "X":
                ev["dur"] = r["dur"] / 1e3
            if r["ph"] == "i":
                ev["s"] = "t"                # thread-scoped instant
            args = dict(r["args"] or {})
            if r["step"] is not None:
                args["step"] = r["step"]
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def to_sink(self, sink) -> int:
        """Feed retained spans into a :class:`TelemetrySink` as per-step
        records: every span with a ``step`` becomes
        ``{"step": s, "span/<name>": seconds}`` (instants contribute a
        ``event/<name>`` count of 1). Records flow through the sink's
        normal step bucketing/aggregation; returns the number fed. The
        caller owns the sink's lifecycle (``flush``/``close``)."""
        fed = 0
        for r in self.records():
            if r["step"] is None:
                continue
            if r["ph"] == "X":
                rec: dict[str, Any] = {"step": r["step"],
                                       f"span/{r['name']}": r["dur"] / 1e9}
            else:
                rec = {"step": r["step"], f"event/{r['name']}": 1.0}
            sink.log_metrics(rec)
            fed += 1
        return fed


#: process-wide default tracer — starts disabled alongside the registry
_default = SpanTracer(enabled=False)


def tracer() -> SpanTracer:
    """The process-wide default tracer every instrumented module uses."""
    return _default
