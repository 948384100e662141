"""Subspace telemetry and closed-loop rank / refresh control, the
counterpart of ``repro/telemetry`` (the port imports nothing of ``repro``).

Layers (the host-side pieces import lazily: the optimizer stack pulls in
``stats`` alone, never the file writers or the controllers):

  stats.py        per-step metrics: :class:`SubspaceStats` emitted per leaf
                  by the low-rank rules, collected through the transform
                  chain's ``Context``; ``to_host`` is the Trainer's one bulk
                  device -> host copy of a step's stats.
  sink.py         host-side sink: ring buffer + JSONL/CSV writers with
                  step-bucketed aggregation; plugs into the Trainer's
                  ``log_metrics`` hook.
  controllers.py  closed-loop controllers: per-layer rank allocator and
                  adaptive refresh scheduler, both checkpointable.
  adaptive.py     runtime glue: rebuilds the optimizer with per-leaf
                  overrides when a controller moves, migrating its state.
"""
from .stats import (  # noqa: F401
    StatsCollector,
    SubspaceStats,
    active_collector,
    collect,
)
