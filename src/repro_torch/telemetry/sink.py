"""Host-side telemetry sink: ring buffer + JSONL/CSV writers.

Plugs into the Trainer's structured ``log_metrics(record)`` hook
(``train/loop.py``). Each record is the per-step metrics dict (host floats
plus the ``telemetry`` subtree of per-leaf :class:`SubspaceStats`, as host
numpy after the Trainer's one bulk copy); the sink converts to host floats,
buckets ``every`` consecutive steps into one aggregated row (mean over the
bucket, elementwise for stacked-layer lists), keeps the last ``ring`` rows
in memory for controllers and tests, and appends each row to a JSONL or CSV
file. Given the same records it writes the same bytes as the JAX package's
sink.

A tensor left on the card in a record is copied here, one copy per field:
the Trainer hands over host values, so on its path the sink adds no copy.
Use a coarser ``every`` if the host-side cost of the rows ever matters.
"""
from __future__ import annotations

import collections
import csv
import json
import os
from typing import Any

import numpy as np
import torch

FORMATS = ("jsonl", "csv")


def _to_host(val) -> Any:
    """Scalar / array / tensor -> float or nested list (JSON-ready)."""
    if isinstance(val, torch.Tensor):
        val = val.detach().float().cpu().numpy()
    arr = np.asarray(val)
    if arr.ndim == 0:
        return float(arr)
    return arr.astype(np.float64).tolist()


def flatten_record(record: dict, sep: str = "/") -> dict[str, Any]:
    """Nested metrics dict -> flat ``{path key: float | list}``.

    NamedTuples (SubspaceStats) flatten by field name, nested dicts (the
    ``telemetry`` subtree) by key, so a stacked leaf's captured energy lands
    under e.g. ``telemetry/segments/0/p0/attn/wq/kernel/captured_energy``.
    """
    flat: dict[str, Any] = {}

    def walk(prefix: str, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{sep}{k}" if prefix else str(k), v)
        elif hasattr(node, "_fields"):          # NamedTuple (SubspaceStats)
            for k, v in zip(node._fields, node):
                walk(f"{prefix}{sep}{k}" if prefix else str(k), v)
        elif node is None:
            pass
        elif isinstance(node, (int, float, bool)):
            flat[prefix] = float(node)
        else:
            flat[prefix] = _to_host(node)

    walk("", record)
    return flat


# stat fields whose -1 means "not a measurement" (keep steps, non-index
# projectors, see SubspaceStats): averaging a sentinel with real values
# would produce numbers that are neither, so those entries are left out of
# the bucket mean and a bucket with no valid entry stays -1
_SENTINEL_FIELDS = ("topr_margin", "index_overlap")


def _agg(values: list, *, gated: bool = False) -> Any:
    """Mean over a bucket of rows; elementwise for list-valued entries.
    ``gated=True`` masks out negative (sentinel) entries first."""
    arr = np.asarray(values, np.float64)
    if gated:
        valid = arr >= 0
        s = np.where(valid, arr, 0.0).sum(axis=0)
        n = valid.sum(axis=0)
        out = np.where(n > 0, s / np.maximum(n, 1), -1.0)
    else:
        out = arr.mean(axis=0)
    return out.tolist() if isinstance(values[0], list) else float(out)


class TelemetrySink:
    """Step-bucketed telemetry writer with an in-memory ring buffer.

    ``sink.log_metrics`` is the Trainer hook. Rows aggregate ``every``
    consecutive records; ``history()`` exposes the ring (newest last).
    """

    def __init__(self, path: str | None, *, fmt: str = "jsonl",
                 every: int = 10, ring: int = 512, append: bool = False):
        """``append=True`` keeps the rows already in the file, the mode for
        a run that resumes from a checkpoint (a restart must not truncate
        the telemetry before it; rows carry step numbers, so a continued
        file stays unambiguous)."""
        if fmt not in FORMATS:
            raise ValueError(f"unknown telemetry format {fmt!r}; "
                             f"allowed: {FORMATS}")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.path = path
        self.fmt = fmt
        self.every = every
        self._bucket: list[dict[str, Any]] = []
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._file = None
        self._csv_fields: list[str] | None = None
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            resuming = append and os.path.exists(path) \
                and os.path.getsize(path) > 0
            self._file = open(path, "a" if append else "w", newline="")
            if resuming and fmt == "csv":
                # the header is already there: reuse its field set so the
                # appended rows stay aligned
                with open(path, newline="") as f:
                    header = f.readline().strip()
                if header:
                    self._csv_fields = header.split(",")
                    self._writer = csv.DictWriter(
                        self._file, self._csv_fields,
                        extrasaction="ignore", restval="")

    # -- ingestion ----------------------------------------------------------
    def log_metrics(self, record: dict) -> None:
        """Trainer hook: one per-step record (step + scalars + per-leaf
        stats). Emits an aggregated row every ``every`` steps."""
        self._bucket.append(flatten_record(record))
        if len(self._bucket) >= self.every:
            self._emit()

    def _emit(self) -> None:
        if not self._bucket:
            return
        keys: dict[str, None] = {}
        for rec in self._bucket:
            keys.update(dict.fromkeys(rec))     # ordered key union
        row = {}
        for k in keys:
            vals = [rec[k] for rec in self._bucket if k in rec]
            if k == "step":
                row[k] = vals[-1]
            else:
                gated = k.rsplit("/", 1)[-1] in _SENTINEL_FIELDS
                row[k] = _agg(vals, gated=gated)
        self._bucket = []
        self._ring.append(row)
        self._write(row)

    # -- output -------------------------------------------------------------
    def _write(self, row: dict) -> None:
        if self._file is None:
            return
        if self.fmt == "jsonl":
            self._file.write(json.dumps(row) + "\n")
        else:
            # CSV needs scalar cells and a stable header: stacked-layer
            # lists collapse to their mean; the first row fixes the field
            # set, keys that appear later are dropped (JSONL keeps all)
            scal = {k: (float(np.mean(v)) if isinstance(v, list) else v)
                    for k, v in row.items()}
            if self._csv_fields is None:
                self._csv_fields = list(scal)
                self._writer = csv.DictWriter(self._file, self._csv_fields,
                                              extrasaction="ignore",
                                              restval="")
                self._writer.writeheader()
            self._writer.writerow(scal)
        self._file.flush()

    def history(self) -> list[dict]:
        """Aggregated rows currently in the ring buffer (newest last)."""
        return list(self._ring)

    def flush(self) -> None:
        """Emit any partial bucket (end of run, preemption)."""
        self._emit()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
