"""Training loop with checkpoint/restart, preemption handling and the
resilience ladder, as in ``repro/train/loop.py``: the single-process core
that ``launch/train.py --supervise`` wraps with a restart supervisor.

``Trainer(train_step=..., init_state_fn=..., batch_fn=...).run(total_steps)``
resumes from the newest verified checkpoint in ``ckpt_dir`` (if any), runs
the steps and keeps one record per committed step in ``metrics_history``:
the step's metrics as host floats. Batches come from a prefetching
:class:`~repro_torch.data.pipeline.DataPipeline`.

Hooks (the reference's):

``log_metrics(record)``
    ``record`` is ``{"step": int, "s_per_step": float, **metrics}``. The
    console line (``[trainer] step N loss L (T ms/step)`` every
    ``log_every`` steps) is built from the same records.
    A step made with ``telemetry=True`` returns its per-leaf stats under
    ``metrics["telemetry"]``; when ``log_metrics`` or ``control_hook`` is
    set, the Trainer copies the whole tree to the host in one piece
    (``telemetry.stats.to_host``: one device -> host copy a step) and both
    hooks read that copy. ``metrics_history`` keeps the scalars only.
``control_hook(step, state, metrics) -> state | None``
    Called every committed step; a non-None return replaces the state.
``extra_state``
    Object with ``state_dict()`` / ``load_state_dict(dict)``: JSON state
    checkpointed in the manifest and restored *before* ``init_state_fn``
    runs (it may decide the restore target's shapes).

Timing: ``s_per_step`` is data wait + dispatch + the sync on the loss, the
split the spans ``train/data_wait``, ``train/dispatch``, ``train/host_sync``
and the ``train_*_seconds`` histograms record (``obs.enable()`` turns them
on). The sync reads the step's scalar metrics to the host, the loss and the
gradient norm, so it waits for the device up to the backward: the
optimizer update of step k finishes on the device while the host dispatches
step k+1. A guarded step (``make_train_step(guard=True)``) reads its
``all_finite`` flag inside the step, after the updates, so there the
dispatch span holds that wait and the loss sync costs nothing.
``sync_sample_every=K`` synchronizes the card every K steps and records
data-ready -> whole-step-done in ``train_full_sync_seconds``.

``state_shardings``: the placements of the train state on a mesh
(``parallel.sharding.train_state_specs`` of the whole state's shapes: the
parameters by their FSDP x TP placements under the active policy, the
optimizer state following them or held by rows under ZeRO-1), a tree or a
function of the state giving one. ``init_state_fn`` gives the state as
this rank's blocks (``train.steps.init_state`` under the mesh cuts them);
the whole parameters exist only inside a step, so the resident bytes
between steps fall and the peak does not. Saves all-gather the split
leaves and only rank 0 writes; restores cut each rank's blocks out of the
whole saved arrays, so the mesh's shape may change between runs (or the
run may go on in one process). Only rank 0 quarantines a corrupt
checkpoint, and a rollback waits at a barrier for rank 0's pending write.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.data.pipeline import DataPipeline

from repro_torch.telemetry.stats import to_host

from .checkpoint import CheckpointManager
from .resilience import TrainingHalted
from .steps import TrainState


def _train_metrics():
    """Training-loop instruments on the process-wide registry, under the
    reference's names (no-ops until ``obs.enable()``)."""
    r = obs.registry()
    return {
        "data_wait": r.histogram(
            "train_data_wait_seconds",
            "blocking on the data pipeline for the step's batch"),
        "dispatch": r.histogram(
            "train_dispatch_seconds",
            "train_step call: host dispatch, returns before the device "
            "finishes (a guarded step includes its flag's sync)"),
        "host_sync": r.histogram(
            "train_host_sync_seconds",
            "blocking on the loss (and the step's other scalars) after "
            "dispatch"),
        "step_wall": r.histogram(
            "train_step_seconds",
            "full step body wall time (data wait + dispatch + loss sync)"),
        "full_sync": r.histogram(
            "train_full_sync_seconds",
            "sampled data-ready -> whole-step-done wall time "
            "(only when sync_sample_every > 0)"),
        "steps": r.counter("train_steps_total",
                           "step outcomes", labels=("outcome",)),
    }


def _sync_device(state: TrainState) -> None:
    """Wait for the card to finish all queued work (nothing on the CPU)."""
    if any(p.is_cuda for p in state.params.values()):
        torch.cuda.synchronize()


class Trainer:
    def __init__(self, *, train_step, init_state_fn, batch_fn,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 keep: int = 3, log_every: int = 10,
                 log_fn: Callable[[str], None] = print,
                 log_metrics: Callable[[dict], None] | None = None,
                 control_hook=None, extra_state=None,
                 state_shardings=None, resilience=None,
                 ckpt_fault_hook=None, sync_sample_every: int = 0):
        self.state_shardings = state_shardings
        # under data parallelism rank 0 writes the checkpoints
        self._writes = (state_shardings is None or not dist.is_initialized()
                        or dist.get_rank() == 0)
        self.train_step = train_step
        self.init_state_fn = init_state_fn
        self.batch_fn = batch_fn
        self.ckpt = (CheckpointManager(ckpt_dir, keep,
                                       fault_hook=ckpt_fault_hook,
                                       log=log_fn)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self.log_metrics = log_metrics
        self.control_hook = control_hook
        self.extra_state = extra_state
        self.resilience = resilience
        self.sync_sample_every = sync_sample_every
        self.metrics_history: list[dict] = []
        self._m = _train_metrics()
        self._tracer = obs.tracer()
        self._preempted = False
        self._window: list[float] = []

    def _install_sigterm(self):
        """Returns the handler it replaced (None off the main thread), for
        ``run`` to put back when it ends."""
        def handler(signum, frame):
            # preemption notice: finish the current step, checkpoint, exit
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:              # not on the main thread
            return None

    def _default_log_metrics(self, record: dict):
        """Console formatter over the structured records."""
        self._window.append(record["s_per_step"])
        step = record["step"]
        if step % self.log_every == 0:
            dt = sum(self._window) / len(self._window)
            self._window = []
            self.log(f"[trainer] step {step} loss "
                     f"{float(record['loss']):.4f} "
                     f"({dt * 1e3:.0f} ms/step)")

    def _emit(self, step: int, metrics: dict, dt: float):
        record = {"step": step, "s_per_step": dt, **metrics}
        self._default_log_metrics(record)
        if self.log_metrics is not None:
            self.log_metrics(record)

    def _ckpt_extra(self) -> dict | None:
        extra = {}
        if self.extra_state is not None:
            extra["extra_state"] = self.extra_state.state_dict()
        if self.resilience is not None:
            extra["resilience"] = self.resilience.state_dict()
        return extra or None

    def _specs(self, state):
        s = self.state_shardings
        return s(state) if callable(s) else s

    def _save(self, step: int, state: TrainState) -> None:
        if self.state_shardings is not None:
            # a collective: every rank gathers, rank 0 writes
            from repro_torch.parallel.sharding import gather_tree

            state = gather_tree(state, self._specs(state))
        if self._writes:
            self.ckpt.async_save(step, state, extra=self._ckpt_extra())

    def _load_checkpoint(self, step: int, *,
                         load_resilience: bool) -> TrainState:
        """Restore ``step``: manifest-carried state first (controller state
        shapes the restore target; the ladder's counters only on a fresh
        resume — a mid-run rollback keeps its escalation state), then the
        tensors, then re-impose the cumulative LR cut (the checkpointed
        ``lr_scale`` entry predates the cuts)."""
        manifest = self.ckpt.manifest(step)
        if self.extra_state is not None:
            extra = manifest.get("extra_state")
            if extra:
                self.extra_state.load_state_dict(extra)
        if load_resilience and self.resilience is not None:
            rs = manifest.get("resilience")
            if rs:
                self.resilience.load_state_dict(rs)
        target = self.init_state_fn()
        state = self.ckpt.restore(
            step, target, None if self.state_shardings is None
            else self._specs(target))
        if self.resilience is not None:
            state = state._replace(
                opt_state=self.resilience.apply_lr_scale(state.opt_state))
        return state

    def run(self, total_steps: int, resume: bool = True) -> TrainState:
        old_handler = self._install_sigterm()
        try:
            return self._run(total_steps, resume)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)

    def _run(self, total_steps: int, resume: bool) -> TrainState:
        res = self.resilience
        start = 0
        state = None
        if resume and self.ckpt is not None:
            # newest checkpoint that passes CRC verification — corrupt ones
            # are quarantined and the next-older candidate is tried
            resume_step = self.ckpt.latest_verified_step(
                quarantine=self._writes)
            if resume_step is not None:
                state = self._load_checkpoint(resume_step,
                                              load_resilience=True)
                start = resume_step
                self.log(f"[trainer] resumed from checkpoint step "
                         f"{resume_step}")
        if state is None:
            state = self.init_state_fn()

        offset = res.data_offset if res is not None else 0
        pipeline = DataPipeline(self.batch_fn, start_step=start + offset)
        history = []
        step = start
        try:
            while step < total_steps:
                t0 = time.perf_counter()
                data_step = step + (res.data_offset if res is not None
                                    else 0)
                with self._tracer.span("train/data_wait", step=step + 1):
                    batch = pipeline.get(data_step)
                t_data = time.perf_counter()
                with self._tracer.span("train/dispatch", step=step + 1):
                    state, metrics = self.train_step(state, batch)
                t_disp = time.perf_counter()
                # the sync on the loss and the step's other scalars (the
                # gradient norm waits for the backward): it proves them
                # ready, not the optimizer update (module docstring)
                with self._tracer.span("train/host_sync", step=step + 1):
                    metrics = {k: v if k == "telemetry" else float(v)
                               for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self._m["data_wait"].observe(t_data - t0)
                self._m["dispatch"].observe(t_disp - t_data)
                self._m["host_sync"].observe(max(dt - (t_disp - t0), 0.0))
                self._m["step_wall"].observe(dt)
                if self.sync_sample_every > 0 \
                        and (step + 1) % self.sync_sample_every == 0:
                    with self._tracer.span("train/full_sync",
                                           step=step + 1):
                        _sync_device(state)
                    self._m["full_sync"].observe(
                        time.perf_counter() - t_data)
                if "telemetry" in metrics and (
                        self.log_metrics is not None
                        or self.control_hook is not None):
                    # one bulk device -> host copy shared by the sink and
                    # the controllers (not one per field, twice)
                    metrics["telemetry"] = to_host(metrics["telemetry"])
                committed = True
                if res is not None:
                    action = res.observe(
                        step + 1, metrics["loss"],
                        bool(metrics.get("all_finite", True)))
                    if action.reason:
                        self.log(f"[resilience] {action.kind}: "
                                 f"{action.reason}")
                    if action.kind == "skip":
                        # the guard already refused the update; the
                        # optimizer step stands still, the data step moves
                        # past the offending batch
                        res.skipped()
                        committed = False
                        self._m["steps"].inc(1, ("skipped",))
                    elif action.kind == "rollback":
                        state, step, pipeline = self._rollback(step,
                                                               pipeline)
                        committed = False
                        self._m["steps"].inc(1, ("rolled_back",))
                    elif action.kind == "halt":
                        if self.ckpt is not None:
                            res.dump(os.path.join(self.ckpt.dir,
                                                  "halt.json"),
                                     context={"trainer_step": step})
                        raise TrainingHalted(action.reason)
                if committed:
                    self._m["steps"].inc(1, ("committed",))
                    # scalars only: every step's per-leaf stats would
                    # pile up, and the sink's ring and file keep them
                    history.append({**{k: v for k, v in metrics.items()
                                       if k != "telemetry"},
                                    "step": step + 1, "s_per_step": dt})
                    self._emit(step + 1, metrics, dt)
                    if self.control_hook is not None:
                        new_state = self.control_hook(step + 1, state,
                                                      metrics)
                        if new_state is not None:
                            state = new_state
                    step += 1
                if self.ckpt is not None and (
                        (committed and step % self.ckpt_every == 0)
                        or self._preempted):
                    self._save(step, state)
                if self._preempted:
                    self.log("[trainer] SIGTERM -> checkpointed, exiting")
                    break
        finally:
            pipeline.close()
            if self.ckpt is not None:
                self.ckpt.wait()
            self.metrics_history = history
        return state

    def _rollback(self, step: int, pipeline):
        """Ladder rung 2/3: restore the last verified checkpoint (or a
        fresh init when none survives verification), shift the data window
        past the offending batches, and rebuild the prefetch pipeline on
        the shifted stream."""
        if self.ckpt is not None:
            self.ckpt.wait()            # never read under a pending writer
            if self.state_shardings is not None and dist.is_initialized():
                dist.barrier()          # ... nor under rank 0's
            to_step = self.ckpt.latest_verified_step(
                quarantine=self._writes)
        else:
            to_step = None
        if to_step is not None:
            state = self._load_checkpoint(to_step, load_resilience=False)
        else:
            # nothing restorable — roll all the way back to initialization
            to_step = 0
            state = self.init_state_fn()
            state = state._replace(
                opt_state=self.resilience.apply_lr_scale(state.opt_state))
        self.log(f"[trainer] rollback: step {step} -> {to_step}")
        self.resilience.rolled_back(from_step=step, to_step=to_step)
        pipeline.close()
        pipeline = DataPipeline(
            self.batch_fn,
            start_step=to_step + self.resilience.data_offset)
        return state, to_step, pipeline
