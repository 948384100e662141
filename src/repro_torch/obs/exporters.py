"""Exporters: Prometheus text exposition + JSONL metric snapshots.

A copy of ``repro/obs/exporters.py`` (the port imports nothing of
``repro``).

Both exporters read :meth:`MetricsRegistry.snapshot` — the instruments'
hot path never formats strings; all naming/escaping happens here, at
export cadence (end of a run, every N steps, on demand).

:func:`prometheus_exposition` renders the standard text format
(``# HELP`` / ``# TYPE`` lines, ``{label="value"}`` series, histogram
``_bucket``/``_sum``/``_count`` with cumulative ``le`` buckets ending at
``+Inf``). :class:`PrometheusExporter` writes it atomically
(``.tmp`` + rename) so a scraper reading the snapshot file never sees a
torn write — the file-based equivalent of a ``/metrics`` endpoint for a
batch process.

:class:`JSONLExporter` appends one JSON object per ``write()`` call —
a timestamped full snapshot — giving a replayable metric history.
"""
from __future__ import annotations

import json
import os
import re
import time

from .metrics import MetricsRegistry

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _escape(value) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _series_suffix(label_names, label_values, extra=()) -> str:
    pairs = [f'{n}="{_escape(v)}"'
             for n, v in zip(label_names, label_values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_exposition(registry: MetricsRegistry) -> str:
    """Render the registry as Prometheus text exposition format 0.0.4."""
    lines: list[str] = []
    for name, snap in registry.snapshot().items():
        if not _NAME_OK.match(name):
            raise ValueError(f"metric name {name!r} is not a valid "
                             "Prometheus metric name")
        kind = snap["type"]
        if snap["help"]:
            lines.append(f"# HELP {name} {_escape(snap['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        label_names = snap["labels"]
        if kind in ("counter", "gauge"):
            for lv, v in sorted(snap["series"].items()):
                lines.append(
                    f"{name}{_series_suffix(label_names, lv)} {_fmt(v)}")
        else:                                           # histogram
            edges = snap["edges"]
            for lv, s in sorted(snap["series"].items()):
                cum = 0
                for edge, c in zip(edges + [float("inf")], s["buckets"]):
                    cum += c
                    suffix = _series_suffix(label_names, lv,
                                            extra=(("le", _fmt(edge)),))
                    lines.append(f"{name}_bucket{suffix} {cum}")
                base = _series_suffix(label_names, lv)
                lines.append(f"{name}_sum{base} {_fmt(s['sum'])}")
                lines.append(f"{name}_count{base} {s['count']}")
    return "\n".join(lines) + "\n" if lines else ""


class PrometheusExporter:
    """Writes the registry as an atomically-replaced text snapshot file."""

    def __init__(self, registry: MetricsRegistry, path: str):
        self.registry = registry
        self.path = path

    def write(self) -> str:
        """Render and atomically publish the snapshot; returns the path."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(prometheus_exposition(self.registry))
        os.replace(tmp, self.path)
        return self.path


class JSONLExporter:
    """Appends one timestamped registry snapshot per ``write()`` call.

    Histogram series are exported with their raw bucket counts plus the
    derived p50/p90/p99 so downstream consumers don't need the edges
    logic; tuple label keys become ``|``-joined strings (JSON objects
    need string keys)."""

    def __init__(self, registry: MetricsRegistry, path: str):
        self.registry = registry
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def _jsonable(self) -> dict:
        out: dict = {}
        for name, snap in self.registry.snapshot().items():
            entry = {k: v for k, v in snap.items() if k != "series"}
            series = {}
            for lv, v in snap["series"].items():
                key = "|".join(str(x) for x in lv) if lv else ""
                if snap["type"] == "histogram":
                    hist = self.registry.get(name)
                    v = dict(v)
                    v["p50"] = hist.quantile(0.5, lv)
                    v["p90"] = hist.quantile(0.9, lv)
                    v["p99"] = hist.quantile(0.99, lv)
                series[key] = v
            entry["series"] = series
            out[name] = entry
        return out

    def write(self, *, step: int | None = None) -> str:
        rec = {"time": time.time(), "metrics": self._jsonable()}
        if step is not None:
            rec["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return self.path
