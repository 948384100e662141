"""Subspace telemetry: the per-leaf stats record and its collector.

The two-step dynamic column selection computes, for free, the quantity that
says how good the low-rank approximation is (paper §4.1: the column-norm
mass of ``S = G @ Q``). Every term is basis-agnostic: ``Q`` may come from
any registered orthogonal-basis backend (``core/transforms.py``);
orthogonality is all the captured-energy identity needs.
:class:`SubspaceStats` packages that, with the index-overlap drift and the
EF-buffer mass that the adaptive controllers need, as a per-leaf NamedTuple
of small fp32 tensors (leading dims = stacked layers), computed inside the
optimizer update from tensors the update already holds.

Collection is out-of-band with respect to the ``Optimizer(init, update)``
signature: a :class:`StatsCollector` is installed with :func:`collect`
around the ``optimizer.update`` call; the chain runtime (``as_optimizer``)
picks it up through :func:`active_collector` and threads it through the
chain's ``Context``; ``lowrank_project`` scopes it to each leaf's path
(the keys ``overrides=`` takes). ``make_train_step(telemetry=True)``
returns ``collector.tree()`` under ``metrics["telemetry"]``.

With no collector installed ``Context.stats`` is ``None`` and the rules
build no stat at all: the step launches exactly what it launches without
telemetry. With one, the stats only read tensors that no later op of the
step writes into, so the update is bit-equal either way.

On the card the stats stay on the device until the Trainer copies a step's
whole tree at once (:func:`to_host`: one flat buffer, one device -> host
copy); :func:`summarize` then works on host numpy.

Under ZeRO-1 (``repro_torch.parallel.zero``) a sharded leaf's rule records
into the leaf's scope directly, as a replicated one does: every term it
records is completed across the shards first (the column statistic, the
keep step's totals, or the gathered momentum of Trion and Dion), so each
rank records the same stats, those of the whole leaf. (The reference
records into a scope inside its ``shard_map`` and re-records the result
outside it.)
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch


class SubspaceStats(NamedTuple):
    """Per-leaf projection-quality statistics (fp32, leading dims = stacked
    layers). All derive from quantities the step already computes: no extra
    ``G``-sized pass on the fused refresh path."""

    captured_energy: torch.Tensor   # ||Q_r^T G||_F^2 / ||G||_F^2 in [0, 1]
    topr_margin: torch.Tensor       # (v_r - v_{r+1}) / v_1 of the column
    #                                 energies; -1 where no selection ran
    index_overlap: torch.Tensor     # |idx_new ∩ idx_prev| / r at refresh
    #                                 steps; -1 when not a measurement (keep
    #                                 steps, dense or non-index projectors)
    ef_norm: torch.Tensor           # ||EF||_F written this step (0: no EF)
    rank_utilization: torch.Tensor  # participation ratio of the r selected
    #                                 column energies, in (0, 1]


def captured_energy(sel_sq: torch.Tensor,
                    total_sq: torch.Tensor) -> torch.Tensor:
    """Energy ratio with a zero-gradient-safe denominator."""
    return sel_sq / torch.clamp_min(total_sq, 1e-30)


def rank_utilization(col_energies: torch.Tensor) -> torch.Tensor:
    """Participation ratio of the selected column energies, normalized to
    (0, 1]: 1 when energy spreads evenly over the r kept columns, 1/r when
    one column holds everything. ``col_energies``: (..., r)."""
    r = col_energies.shape[-1]
    s1 = col_energies.sum(dim=-1)
    s2 = (col_energies * col_energies).sum(dim=-1)
    return (s1 * s1) / (r * torch.clamp_min(s2, 1e-30))


def sentinel(batch, device) -> torch.Tensor:
    """The -1 not-a-measurement value over the stacked-layer dims."""
    return torch.full(tuple(batch), -1.0, dtype=torch.float32, device=device)


class StatsScope(NamedTuple):
    """A collector bound to one leaf's path (what rules see as
    ``ctx.stats``)."""

    collector: "StatsCollector"
    path: str

    def record(self, stats: SubspaceStats) -> None:
        self.collector.record(self.path, stats)


class StatsCollector:
    """Accumulates ``{leaf path: SubspaceStats}`` during one update."""

    def __init__(self):
        self._stats: dict[str, SubspaceStats] = {}

    def record(self, path: str, stats: SubspaceStats) -> None:
        self._stats[path] = stats

    def scope(self, path: str) -> StatsScope:
        return StatsScope(self, path)

    def tree(self) -> dict[str, SubspaceStats]:
        return dict(self._stats)


_ACTIVE: list[StatsCollector] = []


def active_collector() -> StatsCollector | None:
    """The innermost installed collector (None = telemetry off)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def collect():
    """Install a collector around an ``optimizer.update`` call."""
    col = StatsCollector()
    _ACTIVE.append(col)
    try:
        yield col
    finally:
        _ACTIVE.pop()


def to_host(tree: dict[str, SubspaceStats]) -> dict[str, SubspaceStats]:
    """A step's stats tree with every field as host numpy: every tensor is
    flattened into one fp32 buffer, copied to the host once and split back
    (one device -> host copy a step, not one per field)."""
    tensors = [t for st in tree.values() for t in st]
    if not tensors:
        return dict(tree)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    host = flat.cpu().numpy()
    out, at = {}, 0
    for path, st in tree.items():
        fields = []
        for t in st:
            fields.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        out[path] = SubspaceStats(*fields)
    return out


def summarize(stats: SubspaceStats) -> dict[str, float]:
    """Collapse stacked-layer axes to scalar means (controller food), from
    host values (:func:`to_host`'s numpy). Sentinel entries (negative
    margin / overlap on keep steps) are kept as they are: callers filter
    on them."""
    return {name: float(np.mean(np.asarray(val)))
            for name, val in stats._asdict().items()}
