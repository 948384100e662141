"""Deterministic fault injection (chaos harness) for the train substrate,
as in ``repro/train/chaos.py``, with the same JSON plan schema
(docs/resilience.md).

A :class:`ChaosPlan` is a list of :class:`Fault` records keyed on ``(step,
site)`` that the training stack consults at fixed seams:

========== =================== ==============================================
site       modes               seam
========== =================== ==============================================
grads      nan, inf            ``make_train_step(chaos=plan)`` adds the fault
                               value to every gradient leaf on the matching
                               *data* step (the ``_chaos_step`` the plan's
                               batch wrapper stamps into each batch)
checkpoint sigkill, abort      ``CheckpointManager.fault_hook``: SIGKILL the
                               process (or, for in-process tests, kill just
                               the writer thread) at a write stage — ``arg``
                               selects ``pre_write`` / ``mid_write`` /
                               ``pre_publish`` (default)
checkpoint truncate, bitflip   corrupt the just-published ``state.npz``
                               behind its OK marker
data       delay               sleep ``arg`` seconds inside ``batch_fn`` on
                               the matching step (straggler)
========== =================== ==============================================

The reference compares a traced step scalar inside its jitted step. The
port's batch wrapper stamps the data step as a Python int, and the step
compares it on the host: on the matching step it adds NaN or Inf to every
gradient leaf, as the reference does; on every other step it adds nothing.
Faults are keyed on the data step, so a skipped batch or a rolled-back data
window moves past the faulty step instead of replaying it.

Host-side faults fire once. The reference keeps that record in the process,
so a restarted process fires a checkpoint kill again at the same step, and
a supervised drill of one (``--supervise`` with ``sigkill``) would crash
loop. The hook of :meth:`ChaosPlan.bind_checkpoint_dir` also records each
checkpoint fault in ``chaos_fired.json`` in the checkpoint directory before
it acts, and a plan bound to that directory later skips the faults listed
there: a checkpoint fault fires once per run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Callable

from .checkpoint import _WriterInterrupt

_SITES = {
    "grads": ("nan", "inf"),
    "checkpoint": ("sigkill", "abort", "truncate", "bitflip"),
    "data": ("delay",),
}
_STAGES = ("pre_write", "mid_write", "pre_publish", "published")
_CHAOS_KEY = "_chaos_step"
_FIRED_FILE = "chaos_fired.json"


@dataclasses.dataclass(frozen=True)
class Fault:
    """One deterministic fault. ``step`` is the data step (``grads`` /
    ``data`` sites) or the checkpoint step (``checkpoint`` site); ``arg``
    is mode-specific: the write stage for ``sigkill``/``abort``, the sleep
    seconds for ``delay``, ignored otherwise."""

    step: int
    site: str
    mode: str
    arg: Any = None

    def __post_init__(self):
        if self.site not in _SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"have {sorted(_SITES)}")
        if self.mode not in _SITES[self.site]:
            raise ValueError(f"site {self.site!r} has no mode "
                             f"{self.mode!r}; have {_SITES[self.site]}")
        if self.mode in ("sigkill", "abort") and self.arg is not None \
                and self.arg not in _STAGES:
            raise ValueError(f"checkpoint stage {self.arg!r} unknown; "
                             f"have {_STAGES}")


class ChaosPlan:
    """A deterministic fault schedule plus the host bookkeeping (one-shot
    firing for the host-side faults; gradient faults are pure functions of
    the data step, so they need none)."""

    def __init__(self, faults: list[Fault] | None = None, *,
                 log_fn: Callable[[str], None] = print):
        self.faults = list(faults or [])
        self.log = log_fn
        self._fired: set[int] = set()   # host-side one-shot bookkeeping

    # -- construction -------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: list[dict] | dict,
                  log_fn: Callable[[str], None] = print) -> "ChaosPlan":
        """Build from the JSON schema: a list of fault dicts (or
        ``{"faults": [...]}``); each dict's ``step`` may be an int or a
        list of ints (expanded to one fault per step)."""
        if isinstance(spec, dict):
            spec = spec.get("faults", [])
        faults = []
        for rec in spec:
            rec = dict(rec)
            steps = rec.pop("step")
            if not isinstance(steps, (list, tuple)):
                steps = [steps]
            for s in steps:
                faults.append(Fault(step=int(s), **rec))
        return cls(faults, log_fn=log_fn)

    @classmethod
    def load(cls, path: str,
             log_fn: Callable[[str], None] = print) -> "ChaosPlan":
        with open(path) as f:
            return cls.from_spec(json.load(f), log_fn=log_fn)

    def to_spec(self) -> list[dict]:
        return [dataclasses.asdict(f) for f in self.faults]

    def at(self, site: str) -> list[Fault]:
        return [f for f in self.faults if f.site == site]

    # -- the step: gradient tampering ---------------------------------------
    def tamper_grads(self, chaos_step: int, grads: dict) -> dict:
        """Add the fault value to every gradient leaf when the batch's data
        step matches a ``grads`` fault (a host compare of ints)."""
        for f in self.at("grads"):
            if int(chaos_step) == f.step:
                bad = float("nan") if f.mode == "nan" else float("inf")
                grads = {k: g + bad for k, g in grads.items()}
        return grads

    # -- host: batch_fn wrapper ---------------------------------------------
    def wrap_batch_fn(self, batch_fn):
        """Stamp ``_chaos_step`` (the data step, a Python int) into every
        batch — the key ``tamper_grads`` compares against — and serve
        ``data``-site faults (straggler delays)."""

        def wrapped(step):
            s = int(step)
            for f in self.at("data"):
                if f.step == s and self._fire(f):
                    delay = float(f.arg or 1.0)
                    self.log(f"[chaos] delaying batch {s} by {delay:g}s")
                    time.sleep(delay)
            batch = dict(batch_fn(step))
            batch[_CHAOS_KEY] = s
            return batch

        return wrapped

    # -- host: checkpoint faults --------------------------------------------
    def checkpoint_hook(self, stage: str, step: int) -> None:
        """``CheckpointManager.fault_hook`` adapter: write-stage kills and
        post-publish corruption. The manager calls it inline from whichever
        thread is writing, so ``abort`` tears exactly the stage it names."""
        for f in self.at("checkpoint"):
            if f.step != step or not self._matches_stage(f, stage):
                continue
            if not self._fire(f):
                continue
            self._on_fire(f)
            if f.mode == "sigkill":
                self.log(f"[chaos] SIGKILL at checkpoint step {step} "
                         f"stage {stage}")
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.mode == "abort":
                self.log(f"[chaos] aborting checkpoint writer at step "
                         f"{step} stage {stage}")
                raise _WriterInterrupt()
            elif f.mode in ("truncate", "bitflip"):
                self._corrupt(f, step)

    @staticmethod
    def _matches_stage(f: Fault, stage: str) -> bool:
        if f.mode in ("sigkill", "abort"):
            return stage == (f.arg or "pre_publish")
        return stage == "published"     # corruption hits the landed files

    def _on_fire(self, f: Fault) -> None:
        """Record a checkpoint fault as fired (the bound hook persists it)."""

    def _corrupt(self, f: Fault, step: int) -> None:
        # the directory is unknown here; the bound hook's closure carries it
        raise RuntimeError("corruption faults need a bound directory — "
                           "use bind_checkpoint_dir()")

    def bind_checkpoint_dir(self, directory: str):
        """Return a ``fault_hook`` bound to the checkpoint directory (the
        corruption modes need to know where the published files live). The
        checkpoint faults that ``chaos_fired.json`` there lists have fired
        in an earlier process of the run and stay fired."""
        plan = self
        record = os.path.join(directory, _FIRED_FILE)
        if os.path.exists(record):
            with open(record) as fh:
                done = json.load(fh)
            for f in self.at("checkpoint"):
                if dataclasses.asdict(f) in done:
                    self._fired.add(id(f))

        def _mark(f: Fault) -> None:
            done = []
            if os.path.exists(record):
                with open(record) as fh:
                    done = json.load(fh)
            os.makedirs(directory, exist_ok=True)
            with open(record + ".tmp", "w") as fh:
                json.dump(done + [dataclasses.asdict(f)], fh)
                fh.flush()
                os.fsync(fh.fileno())       # before a SIGKILL acts
            os.replace(record + ".tmp", record)

        def _corrupt(f: Fault, step: int) -> None:
            path = os.path.join(directory, f"step_{step}", "state.npz")
            if not os.path.exists(path):
                return
            corrupt_file(path, mode=f.mode)
            plan.log(f"[chaos] {f.mode} applied to {path} (behind OK)")

        def hook(stage: str, step: int) -> None:
            plan._corrupt, orig = _corrupt, plan._corrupt
            plan._on_fire, orig_fire = _mark, plan._on_fire
            try:
                plan.checkpoint_hook(stage, step)
            finally:
                plan._corrupt, plan._on_fire = orig, orig_fire

        return hook

    def _fire(self, f: Fault) -> bool:
        key = id(f)
        if key in self._fired:
            return False
        self._fired.add(key)
        return True


def corrupt_file(path: str, *, mode: str = "bitflip") -> None:
    """Silent storage rot: truncate a file to half, or flip one bit in the
    middle — both keep the OK marker and the manifest intact, which is the
    failure CRC verification exists for."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(max(size // 2, 1))
    elif mode == "bitflip":
        with open(path, "r+b") as fh:
            fh.seek(size // 2)
            byte = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([byte[0] ^ 0x10]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


def strip_chaos_key(batch: dict) -> tuple[dict, Any]:
    """Split the plan's step stamp out of a batch (the model must never see
    it). Returns ``(clean_batch, chaos_step_or_None)``."""
    if _CHAOS_KEY not in batch:
        return batch, None
    batch = dict(batch)
    return batch, batch.pop(_CHAOS_KEY)
