"""Resilient training: the guarded step's primitives and the host-side
escalation ladder, as in ``repro/train/resilience.py`` (docs/resilience.md).

**Guard** (``make_train_step(..., guard=True)``): the step computes one
``all_finite`` flag from the loss, the gradient global norm (a sum of
squares over every gradient element, so any NaN/Inf in the gradients
poisons it) and every update leaf's min and max (``all_finite_tree``). The
JAX package commits with a per-leaf ``where`` inside its jitted step, because
its step donates the old buffers. The port's step is functional: it writes
into no tensor of the old state. So the port reads the flag on the host at
the end of the step and returns either the new or the old ``TrainState``:
the same bits, with no third copy of parameters and state (about 2.6 GB for
llama-350m with DCT-AdamW). The read is one sync at the end of the step.

**Escalation ladder** (:class:`ResilienceManager`): host Python that
consumes the flag and a loss-vs-EMA divergence signal every step:

1. *skip*: the guard already refused the update; drop the offending batch
   (the data step advances, the optimizer step does not), up to
   ``max_skips`` consecutive times;
2. *rollback*: restore the last verified checkpoint and skip the offending
   data window;
3. *rollback + LR cut*: later rollbacks also cut the learning rate by
   ``lr_cut`` through the ``lr_scale`` state tensor of
   ``inject_hyperparams`` (:func:`scale_hyperparam`);
4. *halt*: dump diagnostics and exit with :data:`HALT_EXIT_CODE`, which the
   supervisor never restarts.

The arithmetic (the EMA, the spike test, the heal count, the cumulative
cut) is the reference's, line for line, so the same stream of ``(step,
loss, finite)`` gives the same actions. The ladder's counters ride the
checkpoint manifest, so a preemption mid-recovery resumes mid-ladder.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import obs

from .checkpoint import tree_items, tree_map_with_path

#: Exit code for an unrecoverable halt (rung 4). The supervisor treats it
#: as permanent: no restart, the failure is deterministic.
HALT_EXIT_CODE = 86


def _ladder_metrics():
    """Escalation-ladder instruments under the reference's names (no-ops
    until ``obs.enable()``). Every decision also lands as a
    ``resilience/...`` instant on the span tracer."""
    r = obs.registry()
    return {
        "guard_trips": r.counter(
            "resilience_guard_trips_total",
            "steps where the guard reported non-finite"),
        "spikes": r.counter("resilience_loss_spikes_total",
                            "finite steps flagged as loss spikes"),
        "actions": r.counter("resilience_actions_total",
                             "ladder decisions, by rung",
                             labels=("kind",)),
        "lr_cuts": r.counter("resilience_lr_cuts_total",
                             "rollbacks that also cut the learning rate"),
        "lr_scale": r.gauge("resilience_lr_scale",
                            "cumulative learning-rate scale"),
        "rollback_budget": r.gauge(
            "resilience_rollbacks_used",
            "rollbacks consumed against cfg.max_rollbacks"),
    }


class TrainingHalted(RuntimeError):
    """Raised when the escalation ladder is exhausted (rung 4)."""


# ---------------------------------------------------------------------------
# guard primitives over the port's state trees (NamedTuples, dicts, lists,
# tuples, None, Python ints and tensors: ``checkpoint.tree_map_with_path``)
# ---------------------------------------------------------------------------
def all_finite_tree(tree) -> torch.Tensor:
    """0-d bool tensor: every element of every floating leaf is finite
    (integer leaves and Python ints are ignored).

    Each leaf's min and max (one ``aminmax`` reduction, which propagates
    NaN) are finite exactly when all its elements are; the ends of every
    leaf are then tested together. ``torch.isfinite(leaf)`` would allocate
    a leaf-sized ``abs`` and two masks (0.21 GB more peak memory for
    llama-350m, PERF.md §6) and take five launches a leaf."""
    ends = []
    for _, leaf in tree_items(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and leaf.numel():
            ends.extend(e.float() for e in torch.aminmax(leaf))
    if not ends:
        return torch.tensor(True)
    return torch.isfinite(torch.stack(ends)).all()


def select_tree(flag, new, old):
    """``new`` if ``flag`` else ``old``: the commit point of the guarded
    step. ``flag`` is read on the host (one sync); the port's step writes
    into no tensor of ``old``, so returning it whole is the refused step."""
    return new if bool(flag) else old


def scale_hyperparam(opt_state, name: str, factor) -> tuple[Any, int]:
    """Multiply every ``inject_hyperparams`` state entry called ``name`` by
    ``factor``, in the entry's own dtype (same shapes, same dtypes; new
    tensors, the old state is untouched). Returns ``(new_state, n_scaled)``;
    ``n_scaled == 0`` means the optimizer was built without that injected
    hyperparameter."""
    hits = 0

    def visit(path, leaf):
        nonlocal hits
        if path[-2:] == (".hyperparams", name):
            hits += 1
            return leaf * torch.tensor(factor, dtype=leaf.dtype,
                                       device=leaf.device)
        return leaf

    new_state = tree_map_with_path(visit, opt_state)
    return new_state, hits


# ---------------------------------------------------------------------------
# host-side escalation ladder
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of the escalation ladder (docs/resilience.md for the guide)."""

    #: consecutive bad steps tolerated as plain batch skips before the
    #: ladder escalates to a rollback
    max_skips: int = 2
    #: rollbacks (to the last verified checkpoint) before the run halts
    max_rollbacks: int = 3
    #: learning-rate factor applied on the second and later rollbacks
    #: (through the ``lr_scale`` injected hyperparameter; cumulative)
    lr_cut: float = 0.5
    #: loss > spike_factor * EMA(loss) counts as a divergence signal
    spike_factor: float = 4.0
    #: EMA decay for the divergence reference
    ema_decay: float = 0.98
    #: healthy steps before spike detection arms
    ema_warmup: int = 10
    #: consecutive spiking (but finite) steps tolerated before rollback —
    #: finite spikes have already been committed, so there is no skip rung
    spike_patience: int = 3
    #: healthy steps after which the rollback budget heals back to zero
    heal_steps: int = 200


class Action(NamedTuple):
    """One ladder decision. ``kind``: ``ok`` | ``skip`` | ``rollback`` |
    ``halt``. ``lr_factor`` < 1 asks the trainer to cut the LR after the
    rollback restore; ``reason`` is the log/diagnostic line."""

    kind: str
    reason: str = ""
    lr_factor: float = 1.0


class ResilienceManager:
    """Consumes per-step health signals, emits ladder :class:`Action`\\ s,
    and owns the recovery bookkeeping that must survive restarts
    (cumulative ``lr_scale``, the data-window ``data_offset``, the rollback
    budget). The Trainer executes the actions; this class never touches
    device state itself."""

    def __init__(self, cfg: ResilienceConfig | None = None, *,
                 log_fn: Callable[[str], None] = print):
        self.cfg = cfg or ResilienceConfig()
        self.log = log_fn
        self._m = _ladder_metrics()
        self._tracer = obs.tracer()
        self.consecutive_bad = 0
        self.consecutive_spikes = 0
        self.n_rollbacks = 0
        self.n_skips = 0
        self.healthy_streak = 0
        self.lr_scale = 1.0
        self.data_offset = 0
        self.loss_ema: float | None = None
        self.ema_steps = 0
        self.halted: str | None = None
        self._recent: list[dict] = []   # rolling diagnostics window

    # -- policy -------------------------------------------------------------
    def observe(self, step: int, loss: float, all_finite: bool) -> Action:
        """Classify one completed step and decide the ladder rung.

        ``all_finite=False`` means the guard already refused the update
        (state unchanged); a finite loss above ``spike_factor`` x EMA is a
        divergence signal on a step that *did* commit — it has no skip
        rung, only patience before rollback."""
        self._recent.append({"step": step, "loss": float(loss),
                             "all_finite": bool(all_finite)})
        del self._recent[:-50]
        if not all_finite:
            self.consecutive_bad += 1
            self.healthy_streak = 0
            self._m["guard_trips"].inc()
            self._tracer.instant("resilience/guard_trip", step=step,
                                 loss=float(loss),
                                 consecutive=self.consecutive_bad)
            if self.consecutive_bad <= self.cfg.max_skips:
                self.n_skips += 1
                return self._decided(step, Action(
                    "skip", f"non-finite step ({self.consecutive_bad}/"
                            f"{self.cfg.max_skips} consecutive)"))
            return self._decided(step, self._escalate(
                "non-finite steps persist through "
                f"{self.cfg.max_skips} skipped batches"))
        spiking = (self.ema_steps >= self.cfg.ema_warmup
                   and self.loss_ema is not None
                   and loss > self.cfg.spike_factor * self.loss_ema)
        if spiking:
            self.consecutive_spikes += 1
            self.healthy_streak = 0
            self._m["spikes"].inc()
            self._tracer.instant("resilience/loss_spike", step=step,
                                 loss=float(loss), ema=float(self.loss_ema),
                                 consecutive=self.consecutive_spikes)
            if self.consecutive_spikes <= self.cfg.spike_patience:
                return Action("ok",
                              f"loss spike {loss:.3g} vs EMA "
                              f"{self.loss_ema:.3g} ({self.consecutive_spikes}"
                              f"/{self.cfg.spike_patience})")
            return self._decided(step, self._escalate(
                f"loss diverged: {loss:.3g} > {self.cfg.spike_factor:g}x "
                f"EMA {self.loss_ema:.3g} for "
                f"{self.cfg.spike_patience} steps"))
        # healthy step: update the divergence reference, heal the ladder
        self.consecutive_bad = 0
        self.consecutive_spikes = 0
        self.healthy_streak += 1
        d = self.cfg.ema_decay
        self.loss_ema = (loss if self.loss_ema is None
                         else d * self.loss_ema + (1.0 - d) * loss)
        self.ema_steps += 1
        if self.healthy_streak == self.cfg.heal_steps and self.n_rollbacks:
            self.log(f"[resilience] {self.cfg.heal_steps} healthy steps — "
                     f"rollback budget healed")
            self.n_rollbacks = 0
        return Action("ok")

    def _decided(self, step: int, action: Action) -> Action:
        """Record a non-ok ladder decision: rung counter, gauges, and a
        structured instant carrying the full decision."""
        self._m["actions"].inc(1, (action.kind,))
        if action.lr_factor != 1.0:
            self._m["lr_cuts"].inc()
        self._m["lr_scale"].set(self.lr_scale)
        self._m["rollback_budget"].set(self.n_rollbacks)
        self._tracer.instant(f"resilience/{action.kind}", step=step,
                             reason=action.reason,
                             lr_factor=action.lr_factor,
                             lr_scale=self.lr_scale,
                             rollbacks=self.n_rollbacks,
                             skips=self.n_skips)
        return action

    def _escalate(self, reason: str) -> Action:
        self.consecutive_bad = 0
        self.consecutive_spikes = 0
        self.n_rollbacks += 1
        if self.n_rollbacks > self.cfg.max_rollbacks:
            self.halted = (f"{reason}; ladder exhausted after "
                           f"{self.cfg.max_rollbacks} rollbacks")
            return Action("halt", self.halted)
        lr_factor = self.cfg.lr_cut if self.n_rollbacks >= 2 else 1.0
        if lr_factor != 1.0:
            self.lr_scale *= lr_factor
        return Action("rollback",
                      f"{reason} (rollback {self.n_rollbacks}/"
                      f"{self.cfg.max_rollbacks}"
                      + (f", lr x{self.lr_scale:g}" if lr_factor != 1.0
                         else "") + ")",
                      lr_factor=lr_factor)

    def rolled_back(self, from_step: int, to_step: int) -> None:
        """Trainer callback after a restore: shift the data window past the
        offending batches and reset the divergence reference."""
        # the next fetch at trainer step `to_step` consumes the batch
        # *after* the one that went bad at trainer step `from_step`
        self.data_offset += (from_step - to_step) + 1
        self.loss_ema = None
        self.ema_steps = 0
        self.healthy_streak = 0

    def skipped(self) -> None:
        """Trainer callback after a skip: the optimizer step is retried
        with the next batch, so the data window advances by one."""
        self.data_offset += 1

    def apply_lr_scale(self, opt_state):
        """Re-impose the cumulative LR cut on a freshly restored optimizer
        state (the checkpointed ``lr_scale`` entry predates the cuts)."""
        if self.lr_scale == 1.0:
            return opt_state
        new_state, hits = scale_hyperparam(opt_state, "lr_scale",
                                           self.lr_scale)
        if not hits:
            self.log("[resilience] LR-cut rung unavailable: optimizer has "
                     "no injected 'lr_scale' hyperparameter (build it with "
                     "lr_scale=True); continuing with plain rollback")
            return opt_state
        return new_state

    # -- diagnostics --------------------------------------------------------
    def dump(self, path: str, context: dict | None = None) -> str:
        """Write the halt diagnostic (ladder state + the recent-step
        window) as JSON; returns the path."""
        record = {
            "halted": self.halted,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "ladder": self.state_dict(),
            "recent_steps": self._recent,
            **(context or {}),
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=2)
        self.log(f"[resilience] halt diagnostics -> {path}")
        return path

    # -- persistence (rides the checkpoint manifest) ------------------------
    def state_dict(self) -> dict:
        return {
            "n_rollbacks": self.n_rollbacks,
            "n_skips": self.n_skips,
            "lr_scale": self.lr_scale,
            "data_offset": self.data_offset,
            "healthy_streak": self.healthy_streak,
        }

    def load_state_dict(self, d: dict) -> None:
        self.n_rollbacks = int(d.get("n_rollbacks", 0))
        self.n_skips = int(d.get("n_skips", 0))
        self.lr_scale = float(d.get("lr_scale", 1.0))
        self.data_offset = int(d.get("data_offset", 0))
        self.healthy_streak = int(d.get("healthy_streak", 0))
