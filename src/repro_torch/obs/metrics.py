"""Process-wide metrics registry: counters, gauges, histograms.

A copy of ``repro/obs/metrics.py`` (the port imports nothing of
``repro``). These instruments measure the *host runtime* — request
latencies, pool occupancy, phase durations — with a hot path cheap enough
to run on every serving step.

Hot-path discipline:

  * Label sets are plain tuples used directly as dict keys — no string
    formatting, no label joining, no allocation beyond the tuple the
    caller already holds. Formatting happens only at export time
    (:mod:`repro_torch.obs.exporters`).
  * Every instrument holds a reference to its registry's ``enabled``
    flag holder; a disabled registry makes ``inc``/``set``/``observe``
    a single attribute test and return. Instrumented code therefore
    never needs its own ``if obs.enabled()`` guards.
  * Instruments are host-side only: nothing here touches a tensor, so
    instrumenting a step adds no device work and no synchronisation.

Histograms use fixed bucket edges chosen at registration (defaults
cover 100µs..100s in log-spaced steps, the serving-latency range).
``observe`` is a bisect into those edges; quantiles are estimated at
read time by linear interpolation inside the bucket — the classic
Prometheus-style fixed-bucket estimator, exact at bucket edges.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable, Optional

#: default histogram edges: log-spaced 100µs .. 100s (seconds) — covers
#: token latencies, step phases, and checkpoint IO on CPU and accelerator
DEFAULT_BUCKETS = tuple(
    round(m * 10.0 ** e, 10)
    for e in range(-4, 2)
    for m in (1.0, 2.5, 5.0)
) + (100.0,)

_NO_LABELS = ()


class _Enabled:
    """Shared mutable flag; instruments read ``.on`` on every record."""

    __slots__ = ("on",)

    def __init__(self, on: bool = True):
        self.on = on


class Counter:
    """Monotonic counter family, one float per label tuple."""

    __slots__ = ("name", "help", "label_names", "series", "_enabled")

    def __init__(self, name: str, help: str, label_names: tuple[str, ...],
                 enabled: _Enabled):
        self.name = name
        self.help = help
        self.label_names = label_names
        self.series: dict[tuple, float] = {}
        self._enabled = enabled

    def inc(self, amount: float = 1.0, labels: tuple = _NO_LABELS) -> None:
        if not self._enabled.on:
            return
        self.series[labels] = self.series.get(labels, 0.0) + amount

    def value(self, labels: tuple = _NO_LABELS) -> float:
        return self.series.get(labels, 0.0)

    def snapshot(self) -> dict:
        return {"type": "counter", "help": self.help,
                "labels": list(self.label_names),
                "series": {k: v for k, v in self.series.items()}}


class Gauge:
    """Set-to-current-value instrument, one float per label tuple."""

    __slots__ = ("name", "help", "label_names", "series", "_enabled")

    def __init__(self, name: str, help: str, label_names: tuple[str, ...],
                 enabled: _Enabled):
        self.name = name
        self.help = help
        self.label_names = label_names
        self.series: dict[tuple, float] = {}
        self._enabled = enabled

    def set(self, value: float, labels: tuple = _NO_LABELS) -> None:
        if not self._enabled.on:
            return
        self.series[labels] = value

    def add(self, amount: float, labels: tuple = _NO_LABELS) -> None:
        if not self._enabled.on:
            return
        self.series[labels] = self.series.get(labels, 0.0) + amount

    def value(self, labels: tuple = _NO_LABELS) -> float:
        return self.series.get(labels, 0.0)

    def snapshot(self) -> dict:
        return {"type": "gauge", "help": self.help,
                "labels": list(self.label_names),
                "series": {k: v for k, v in self.series.items()}}


class _HistSeries:
    """One label tuple's histogram state: per-bucket counts + running
    count/sum/min/max."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets     # one per edge + overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram:
    """Fixed-bucket histogram family with quantile estimation.

    ``edges`` are the inclusive upper bounds of the finite buckets (a
    value lands in the first bucket whose edge is >= value); values above
    the last edge land in the implicit +Inf overflow bucket. Quantiles
    interpolate linearly within the winning bucket; an overflow-bucket
    quantile reports the observed max (the only honest bound there).
    """

    __slots__ = ("name", "help", "label_names", "edges", "series",
                 "_enabled")

    def __init__(self, name: str, help: str, label_names: tuple[str, ...],
                 edges: tuple[float, ...], enabled: _Enabled):
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram {name!r}: bucket edges must be a "
                             f"non-empty ascending sequence, got {edges}")
        self.name = name
        self.help = help
        self.label_names = label_names
        self.edges = tuple(float(e) for e in edges)
        self.series: dict[tuple, _HistSeries] = {}
        self._enabled = enabled

    def observe(self, value: float, labels: tuple = _NO_LABELS) -> None:
        if not self._enabled.on:
            return
        s = self.series.get(labels)
        if s is None:
            s = self.series[labels] = _HistSeries(len(self.edges) + 1)
        s.counts[bisect_left(self.edges, value)] += 1
        s.count += 1
        s.sum += value
        if value < s.min:
            s.min = value
        if value > s.max:
            s.max = value

    # -- reads --------------------------------------------------------------
    def count(self, labels: tuple = _NO_LABELS) -> int:
        s = self.series.get(labels)
        return s.count if s else 0

    def sum(self, labels: tuple = _NO_LABELS) -> float:
        s = self.series.get(labels)
        return s.sum if s else 0.0

    def mean(self, labels: tuple = _NO_LABELS) -> float:
        s = self.series.get(labels)
        return s.sum / s.count if s and s.count else 0.0

    def quantile(self, q: float, labels: tuple = _NO_LABELS) -> float:
        """Estimated ``q``-quantile (0 <= q <= 1) from the bucket counts.

        Linear interpolation inside the winning bucket, with the bucket's
        lower bound clamped to the observed min (first bucket) and the
        overflow bucket reporting the observed max."""
        s = self.series.get(labels)
        if not s or not s.count:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = q * s.count
        seen = 0
        for i, c in enumerate(s.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i == len(self.edges):          # overflow bucket
                    return s.max
                lo = self.edges[i - 1] if i else min(s.min, self.edges[0])
                lo = max(lo, s.min)
                hi = min(self.edges[i], s.max)
                if hi <= lo:
                    return hi
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return s.max

    def snapshot(self) -> dict:
        out = {}
        for labels, s in self.series.items():
            out[labels] = {
                "count": s.count, "sum": s.sum,
                "min": s.min if s.count else None,
                "max": s.max if s.count else None,
                "buckets": list(s.counts),
            }
        return {"type": "histogram", "help": self.help,
                "labels": list(self.label_names),
                "edges": list(self.edges), "series": out}


class MetricsRegistry:
    """Named instruments, created once and looked up cheaply.

    ``counter``/``gauge``/``histogram`` are get-or-create: a second
    registration with the same name returns the existing instrument (and
    raises on a kind/labels/edges mismatch — two call sites silently
    sharing a name with different meanings is a bug). Instrumented
    modules therefore register at call-site module scope without
    coordinating.
    """

    def __init__(self, *, enabled: bool = True):
        self._enabled = _Enabled(enabled)
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    # -- enable/disable -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled.on

    def enable(self) -> None:
        self._enabled.on = True

    def disable(self) -> None:
        self._enabled.on = False

    # -- registration -------------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, requested {cls.__name__}")
                if tuple(labels) != m.label_names:
                    raise ValueError(
                        f"metric {name!r} label mismatch: registered "
                        f"{m.label_names}, requested {tuple(labels)}")
                if kw.get("edges") is not None \
                        and tuple(kw["edges"]) != m.edges:
                    raise ValueError(
                        f"histogram {name!r} bucket-edge mismatch")
                return m
            if cls is Histogram:
                edges = kw.get("edges") or DEFAULT_BUCKETS
                m = Histogram(name, help, tuple(labels), edges,
                              self._enabled)
            else:
                m = cls(name, help, tuple(labels), self._enabled)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  edges: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   edges=tuple(edges) if edges else None)

    # -- reads --------------------------------------------------------------
    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Plain-dict view of every instrument — the test/exporter API."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def reset(self) -> None:
        """Drop every recorded series (instruments stay registered) —
        lets tests and benchmark phases start from a clean slate."""
        with self._lock:
            for m in self._metrics.values():
                m.series = {}


# ---------------------------------------------------------------------------
# process-wide default registry
# ---------------------------------------------------------------------------
#: observability is opt-in: the default registry starts disabled, so an
#: un-configured process pays one attribute test per instrumented site
_default = MetricsRegistry(enabled=False)


def registry() -> MetricsRegistry:
    """The process-wide default registry every instrumented module uses."""
    return _default
