"""Closed-loop controllers fed by subspace telemetry, the counterpart of
``repro/telemetry/controllers.py``.

Two controllers, both keyed by leaf path (the keys telemetry emits under and
``lowrank_project(overrides=...)`` takes, e.g.
``segments/0/p0/attn/wq/kernel``):

:class:`RankAllocator`
    Redistributes a global rank budget across layers by captured energy
    (AdaRankGrad's observation: per-layer gradient rank shrinks over
    training, so a fixed global ``r`` wastes memory where energy is
    concentrated and starves layers where it is spread). Bounded
    (``min_rank`` / ``max_rank`` / ``quantum``), hysteresis-damped (moves
    at most ``max_step`` quanta per decision, skips moves smaller than one
    quantum) and budget-preserving: the weighted sum of ranks (weights =
    moment elements per rank unit) never exceeds the uniform-rank budget,
    so the optimizer state stays within the fixed-rank footprint.

:class:`RefreshScheduler`
    Stretches or shrinks each leaf's selection ``update_interval`` on a
    power-of-two ladder from measured index-overlap drift (Online Subspace
    Descent: the refresh cadence should follow drift, not a fixed T_u).
    Low drift: refresh less often; high drift: refresh every step.

Both are host objects with JSON ``state_dict`` / ``load_state_dict``, so
they ride the checkpoint manifest and survive preemption.

Rank shapes the moments, so adopting a new allocation means rebuilding the
optimizer and migrating its state: :func:`migrate_opt_state` keeps every
tensor whose shape survived (the step, the bases, the full-rank Adam
moments, the EF buffers: EF is rank-independent) and re-initializes only
the changed leaves' low-rank moments and indices (a subspace reset; the EF
buffer carries the residual history across it).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.optim.common import default_label_fn, oriented_dims


def _controller_metrics():
    """Controller instruments (no-ops until ``obs.enable()``). Each adopted
    proposal also lands on the span tracer as an instant carrying the
    before / after maps."""
    r = obs.registry()
    return {
        "rank_decisions": r.counter(
            "controller_rank_reallocations_total",
            "adopted rank re-allocations"),
        "interval_decisions": r.counter(
            "controller_interval_changes_total",
            "adopted refresh-interval ladder moves"),
        "ranks_changed": r.counter(
            "controller_ranks_changed_total",
            "leaves whose rank moved across all re-allocations"),
        "rank_spread": r.gauge(
            "controller_rank_spread",
            "max - min allocated rank after the last decision"),
    }


# ---------------------------------------------------------------------------
# leaf inventory
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafInfo:
    """Static per-leaf facts the controllers need (from parameter shapes)."""

    rows: int    # total moment rows = prod(shape) / cols (stacked included)
    cols: int    # projected (min oriented) dimension: caps the rank


def leaf_inventory(params: dict, label_fn=None) -> dict[str, LeafInfo]:
    """``{leaf path: LeafInfo}`` for every low-rank-routed matrix leaf of a
    flat parameter dict. Takes any tensors, ``device="meta"`` ones included
    (``models.transformer.init_params(cfg, seed, "meta")``: the shapes
    without the values)."""
    label_fn = label_fn or default_label_fn
    out: dict[str, LeafInfo] = {}
    for path, p in params.items():
        if label_fn(path, p) != "lowrank":
            continue
        rows, cols = oriented_dims(p.shape)
        out[path] = LeafInfo(rows=math.prod(p.shape) // cols, cols=cols)
    return out


def _quantize(r: float, q: int) -> int:
    return max(q, int(round(r / q)) * q)


# ---------------------------------------------------------------------------
# rank allocator
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RankAllocatorConfig:
    base_rank: int                  # the uniform rank defining the budget
    min_rank: int = 0               # floor; 0 -> max(quantum, base_rank/4)
    max_rank: int = 0               # cap per leaf; 0 -> 4 * base_rank
    quantum: int = 8                # ranks move in multiples of this
    max_step: int = 4               # max quanta moved per decision per leaf
    decide_every: int = 50          # steps between reallocation decisions
    ema_decay: float = 0.9          # captured-energy EMA smoothing
    deadband: float = 0.02          # min captured-energy spread to act on

    def cap(self) -> int:
        return self.max_rank or 4 * self.base_rank

    def floor(self) -> int:
        return self.min_rank or max(self.quantum, self.base_rank // 4)


class RankAllocator:
    """Per-layer rank allocation by captured energy, budget-preserving.

    Control law (every ``decide_every`` steps): leaves with a *low* EMA
    captured energy have under-provisioned subspaces and bid for more rank;
    leaves near 1.0 release it. Targets are the budget-weighted
    water-filling of the deficits ``1 - ema``; each leaf then moves at most
    ``max_step`` quanta toward its target, and a repair pass walks rank
    back off the lowest-deficit leaves until the weighted budget holds
    again.
    """

    def __init__(self, cfg: RankAllocatorConfig,
                 leaves: dict[str, LeafInfo]):
        if not leaves:
            raise ValueError("RankAllocator needs at least one lowrank leaf")
        self.cfg = cfg
        self.leaves = leaves
        r0 = cfg.base_rank
        self.alloc: dict[str, int] = {
            p: min(r0, li.cols) for p, li in leaves.items()}
        # budget in weighted rank units: sum_i rows_i * r_i (elements of ONE
        # moment buffer; m and v scale alike, so the ratio is exact)
        self.budget = sum(leaves[p].rows * r for p, r in self.alloc.items())
        self.ema: dict[str, float] = {}
        self.last_decision = 0
        self.n_decisions = 0
        self._m = _controller_metrics()
        self._tracer = obs.tracer()

    # -- telemetry ingestion ------------------------------------------------
    def observe(self, step: int, stats_by_path: dict[str, dict]) -> None:
        """Feed per-leaf stat summaries ({path: {"captured_energy": f, ...}})."""
        d = self.cfg.ema_decay
        for path, st in stats_by_path.items():
            if path not in self.leaves:
                continue
            ce = float(st["captured_energy"])
            if not math.isfinite(ce):
                continue
            prev = self.ema.get(path)
            self.ema[path] = ce if prev is None else d * prev + (1 - d) * ce

    # -- decision -----------------------------------------------------------
    def propose(self, step: int) -> dict[str, int] | None:
        """New allocation, or None when nothing should change."""
        cfg = self.cfg
        if step - self.last_decision < cfg.decide_every:
            return None
        if len(self.ema) < len(self.leaves):
            return None                       # not every leaf observed yet
        self.last_decision = step
        emas = {p: min(max(self.ema[p], 0.0), 1.0) for p in self.leaves}
        if max(emas.values()) - min(emas.values()) < cfg.deadband:
            return None                       # hysteresis: spread too small
        deficits = {p: max(1.0 - e, 1e-3) for p, e in emas.items()}
        w = {p: self.leaves[p].rows for p in self.leaves}
        mean_def = (sum(w[p] * deficits[p] for p in w) / sum(w.values()))

        new: dict[str, int] = {}
        for p, li in self.leaves.items():
            cur = self.alloc[p]
            target = cfg.base_rank * deficits[p] / mean_def
            target = min(max(target, cfg.floor()), cfg.cap(), li.cols)
            delta = max(-cfg.max_step * cfg.quantum,
                        min(cfg.max_step * cfg.quantum, target - cur))
            new[p] = min(_quantize(cur + delta, cfg.quantum), li.cols)

        # repair: shed quanta from the lowest-deficit leaves until the
        # weighted budget constraint holds
        def used(a):
            return sum(self.leaves[p].rows * r for p, r in a.items())

        order = sorted(new, key=lambda p: deficits[p])
        i = 0
        while used(new) > self.budget and i < 10_000:
            p = order[i % len(order)]
            if new[p] - cfg.quantum >= min(cfg.floor(), self.alloc[p]):
                new[p] -= cfg.quantum
            i += 1
        if used(new) > self.budget or new == self.alloc:
            return None
        before = dict(self.alloc)
        self.alloc = new
        self.n_decisions += 1
        moved = {p: (before[p], r) for p, r in new.items()
                 if r != before[p]}
        self._m["rank_decisions"].inc()
        self._m["ranks_changed"].inc(len(moved))
        self._m["rank_spread"].set(max(new.values()) - min(new.values()))
        self._tracer.instant(
            "controller/rank_realloc", step=step,
            changed={p: {"before": b, "after": a}
                     for p, (b, a) in moved.items()},
            budget_used=used(new), budget=self.budget)
        return dict(new)

    # -- persistence --------------------------------------------------------
    def state_dict(self) -> dict:
        return {"alloc": dict(self.alloc), "ema": dict(self.ema),
                "last_decision": self.last_decision,
                "n_decisions": self.n_decisions, "budget": self.budget}

    def load_state_dict(self, d: dict) -> None:
        self.alloc = {str(k): int(v) for k, v in d["alloc"].items()}
        self.ema = {str(k): float(v) for k, v in d["ema"].items()}
        self.last_decision = int(d["last_decision"])
        self.n_decisions = int(d.get("n_decisions", 0))
        self.budget = int(d.get("budget", self.budget))

    def overrides(self) -> dict[str, dict]:
        """The allocation as ``lowrank_project`` override entries (only the
        leaves that differ from the uniform base rank)."""
        r0 = self.cfg.base_rank
        return {p: {"rank": r} for p, r in self.alloc.items()
                if r != min(r0, self.leaves[p].cols)}


# ---------------------------------------------------------------------------
# refresh scheduler
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RefreshSchedulerConfig:
    base_interval: int = 1          # starting T_u
    max_interval: int = 64          # ladder cap (powers of two)
    low_drift: float = 0.15         # drift below this -> stretch interval
    high_drift: float = 0.5         # drift above this -> shrink interval
    ema_decay: float = 0.8          # drift EMA smoothing
    cooldown: int = 50              # min steps between changes per leaf
    decide_every: int = 50


class RefreshScheduler:
    """Adapts each leaf's selection refresh interval to measured drift.

    Drift = ``1 - index_overlap`` observed at refresh steps (keep steps
    report the -1 sentinel and are skipped). A stable subspace doubles the
    interval (skipping redundant selections); a fast-moving one halves it,
    down to a refresh every step. The low / high thresholds leave a
    hysteresis band where nothing changes.
    """

    def __init__(self, cfg: RefreshSchedulerConfig, paths):
        self.cfg = cfg
        self.interval: dict[str, int] = {p: cfg.base_interval for p in paths}
        self.drift_ema: dict[str, float] = {}
        self.last_change: dict[str, int] = {p: 0 for p in paths}
        self.last_decision = 0
        self._m = _controller_metrics()
        self._tracer = obs.tracer()

    def observe(self, step: int, stats_by_path: dict[str, dict]) -> None:
        d = self.cfg.ema_decay
        for path, st in stats_by_path.items():
            if path not in self.interval:
                continue
            # overlap < 0 is the not-a-measurement sentinel: keep steps (no
            # selection ran) and dense or non-index projectors (for which
            # the scheduler is inert: no observation, no proposal). Only
            # refresh-step measurements feed the EMA.
            overlap = float(st["index_overlap"])
            if overlap < 0:
                continue
            drift = 1.0 - overlap
            if not math.isfinite(drift):
                continue
            prev = self.drift_ema.get(path)
            self.drift_ema[path] = (drift if prev is None
                                    else d * prev + (1 - d) * drift)

    def propose(self, step: int) -> dict[str, int] | None:
        cfg = self.cfg
        if step - self.last_decision < cfg.decide_every:
            return None
        self.last_decision = step
        moved: dict[str, tuple[int, int]] = {}
        for p, ema in self.drift_ema.items():
            if step - self.last_change[p] < cfg.cooldown:
                continue
            cur = self.interval[p]
            if ema < cfg.low_drift and cur < cfg.max_interval:
                self.interval[p] = cur * 2
            elif ema > cfg.high_drift and cur > 1:
                self.interval[p] = max(1, cur // 2)
            else:
                continue
            self.last_change[p] = step
            moved[p] = (cur, self.interval[p])
        if not moved:
            return None
        self._m["interval_decisions"].inc()
        self._tracer.instant(
            "controller/interval_change", step=step,
            changed={p: {"before": b, "after": a, "drift":
                         round(self.drift_ema[p], 4)}
                     for p, (b, a) in moved.items()})
        return dict(self.interval)

    def state_dict(self) -> dict:
        return {"interval": dict(self.interval),
                "drift_ema": dict(self.drift_ema),
                "last_change": dict(self.last_change),
                "last_decision": self.last_decision}

    def load_state_dict(self, d: dict) -> None:
        self.interval = {str(k): int(v) for k, v in d["interval"].items()}
        self.drift_ema = {str(k): float(v)
                          for k, v in d["drift_ema"].items()}
        self.last_change = {str(k): int(v)
                            for k, v in d["last_change"].items()}
        self.last_decision = int(d["last_decision"])

    def overrides(self) -> dict[str, dict]:
        return {p: {"update_interval": t} for p, t in self.interval.items()
                if t != self.cfg.base_interval}


# ---------------------------------------------------------------------------
# state migration across an optimizer rebuild
# ---------------------------------------------------------------------------
def merge_overrides(*maps: dict[str, dict] | None) -> dict[str, dict]:
    """Union per-leaf override maps (later maps win on field collisions)."""
    out: dict[str, dict] = {}
    for m in maps:
        for path, fields in (m or {}).items():
            out.setdefault(path, {}).update(fields)
    return out


def _keep_or_fresh(fresh, old):
    """The old tensor where its shape and dtype survived, else the fresh
    one. Host scalars (the chain's step and seed, a leaf's ``inner_step``)
    and ``None`` keep the old value, as the JAX package's 0-d arrays and
    empty subtrees do."""
    if isinstance(fresh, torch.Tensor):
        if (isinstance(old, torch.Tensor) and old.shape == fresh.shape
                and old.dtype == fresh.dtype):
            return old
        return fresh
    return old


def _migrate(fresh, old):
    from repro_torch.optim.projected_adam import ProjAdamLeaf

    if isinstance(fresh, ProjAdamLeaf):
        if old.m.shape == fresh.m.shape:
            return old
        # rank changed: fresh moments / indices / inner step, EF carried
        return ProjAdamLeaf(m=fresh.m, v=fresh.v, proj=fresh.proj,
                            ef=_migrate(fresh.ef, old.ef),
                            inner_step=fresh.inner_step)
    if isinstance(fresh, dict):
        if fresh.keys() != old.keys():
            raise ValueError(f"state trees differ: {sorted(fresh)} vs "
                             f"{sorted(old)}")
        return {k: _migrate(v, old[k]) for k, v in fresh.items()}
    if isinstance(fresh, (tuple, list)):
        if type(fresh) is not type(old) or len(fresh) != len(old):
            raise ValueError(f"state trees differ: {type(fresh)} vs "
                             f"{type(old)}")
        items = [_migrate(f, o) for f, o in zip(fresh, old)]
        if hasattr(fresh, "_fields"):             # NamedTuple
            return type(fresh)(*items)
        return type(fresh)(items)
    return _keep_or_fresh(fresh, old)


def migrate_opt_state(old_state, fresh_state):
    """Carry optimizer state across a rank-reallocation rebuild.

    ``old_state`` and ``fresh_state`` have the same structure (the same
    parameters, the same chain and partition nesting) but the low-rank
    tensors of changed leaves differ in shape. Per tensor: keep the old
    value where shape and dtype survived, else take the fresh one. Per
    ``ProjAdamLeaf`` whose rank changed, the moments, the indices and the
    inner step are reset together (fresh) while the rank-independent EF
    buffer is carried over: a subspace reset whose residual history
    survives in EF.
    """
    return _migrate(fresh_state, old_state)
