"""Runtime glue for the closed-loop controllers, the counterpart of
``repro/telemetry/adaptive.py``.

Rank and refresh interval are static fields of the optimizer's rule (rank
shapes the moment buffers), so a controller decision means: rebuild the
optimizer with the merged per-leaf overrides, make a new train step from
it, and migrate the optimizer state (``migrate_opt_state``: everything
rank-independent survives, changed leaves get a subspace reset whose
residual history is carried by the EF buffer). Decisions are hysteresis-
damped and quantized by the controllers, so rebuilds are rare.

:class:`AdaptiveOptimizerManager` owns that cycle and presents the three
callables the Trainer takes: ``init_state`` / ``step`` / ``control_hook``,
plus ``state_dict`` / ``load_state_dict`` so the controllers' state rides
the checkpoint manifest (the Trainer's ``extra_state``).
"""
from __future__ import annotations

from typing import Any, Callable

from .controllers import RankAllocator, RefreshScheduler, merge_overrides
from .stats import summarize


class AdaptiveOptimizerManager:
    """Owns the optimizer rebuild cycle driven by telemetry.

    Parameters
    ----------
    make_optimizer:
        ``overrides -> Optimizer`` factory (e.g. a ``get_optimizer``
        closure forwarding ``overrides=``).
    make_step:
        ``optimizer -> (TrainState, batch) -> (TrainState, metrics)``
        factory (a ``make_train_step(..., telemetry=True)``); called again
        after every adopted decision.
    make_train_state:
        ``optimizer -> TrainState`` initializer (fresh params and optimizer
        state).
    rank_allocator / refresh_scheduler:
        either may be None (rank-only / refresh-only operation).
    log_fn:
        decision log sink (default print).
    """

    def __init__(self, *, make_optimizer: Callable[[dict | None], Any],
                 make_step: Callable[[Any], Any],
                 make_train_state: Callable[[Any], Any],
                 rank_allocator: RankAllocator | None = None,
                 refresh_scheduler: RefreshScheduler | None = None,
                 log_fn: Callable[[str], None] = print):
        self.make_optimizer = make_optimizer
        self.make_step = make_step
        self.make_train_state = make_train_state
        self.rank_allocator = rank_allocator
        self.refresh_scheduler = refresh_scheduler
        self.log = log_fn
        self.n_rebuilds = 0
        self._build()

    # -- build / rebuild ----------------------------------------------------
    def current_overrides(self) -> dict[str, dict]:
        return merge_overrides(
            self.rank_allocator.overrides() if self.rank_allocator else None,
            self.refresh_scheduler.overrides()
            if self.refresh_scheduler else None)

    def _build(self) -> None:
        ov = self.current_overrides()
        self.optimizer = self.make_optimizer(ov or None)
        self._step_fn = self.make_step(self.optimizer)

    def _rebuild(self, state):
        from repro_torch.core.transforms import basis_cache
        from repro_torch.telemetry.controllers import migrate_opt_state

        self._build()
        self.n_rebuilds += 1
        # re-initializing the optimizer takes the shared n x n bases from
        # the process-wide BasisCache instead of recomputing them
        fresh_opt_state = self.optimizer.init(state.params)
        cs = basis_cache().stats()
        self.log(f"[adaptive] rebuild #{self.n_rebuilds}: basis cache "
                 f"{cs['hits']} hits / {cs['misses']} misses "
                 f"({cs['entries']} bases resident)")
        migrated = migrate_opt_state(state.opt_state, fresh_opt_state)
        return state._replace(opt_state=migrated)

    # -- Trainer plumbing ---------------------------------------------------
    def init_state(self):
        return self.make_train_state(self.optimizer)

    def step(self, state, batch):
        """Stable callable for the Trainer; calls the current step."""
        return self._step_fn(state, batch)

    def control_hook(self, step: int, state, metrics):
        """Trainer hook: feed telemetry, maybe adopt a decision.

        Returns a migrated TrainState when the optimizer was rebuilt, else
        None. The controllers gate their own cadence (``decide_every``), so
        this is cheap to call every step. ``metrics["telemetry"]`` holds
        host values: the Trainer's one bulk copy (``stats.to_host``).
        """
        tel = metrics.get("telemetry")
        if not tel:
            return None
        stats_by_path = {path: summarize(st) for path, st in tel.items()}
        proposals = False
        if self.rank_allocator is not None:
            self.rank_allocator.observe(step, stats_by_path)
            if self.rank_allocator.propose(step) is not None:
                proposals = True
                self.log(f"[adaptive] step {step}: rank reallocation "
                         f"#{self.rank_allocator.n_decisions} -> "
                         f"{self.rank_allocator.alloc}")
        if self.refresh_scheduler is not None:
            self.refresh_scheduler.observe(step, stats_by_path)
            if self.refresh_scheduler.propose(step) is not None:
                proposals = True
                self.log(f"[adaptive] step {step}: refresh intervals -> "
                         f"{self.refresh_scheduler.interval}")
        if not proposals:
            return None
        return self._rebuild(state)

    # -- persistence (the Trainer's extra_state protocol) -------------------
    def state_dict(self) -> dict:
        out: dict[str, Any] = {"n_rebuilds": self.n_rebuilds}
        if self.rank_allocator is not None:
            out["rank_allocator"] = self.rank_allocator.state_dict()
        if self.refresh_scheduler is not None:
            out["refresh_scheduler"] = self.refresh_scheduler.state_dict()
        return out

    def load_state_dict(self, d: dict) -> None:
        """Restore the controllers' state, then rebuild so the optimizer
        (and the state shapes ``init_state`` makes) match the restored
        allocation: call BEFORE restoring the checkpointed train state."""
        self.n_rebuilds = int(d.get("n_rebuilds", 0))
        if self.rank_allocator is not None and "rank_allocator" in d:
            self.rank_allocator.load_state_dict(d["rank_allocator"])
        if self.refresh_scheduler is not None and "refresh_scheduler" in d:
            self.refresh_scheduler.load_state_dict(d["refresh_scheduler"])
        self._build()
