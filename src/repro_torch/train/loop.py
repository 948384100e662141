"""Training loop.

``Trainer(train_step=..., init_state_fn=..., batch_fn=...).run(total_steps)``
initializes the state, runs the steps and keeps one record per step in
``metrics_history``: the step's metrics (host floats) and ``s_per_step``,
the wall time of the step body up to and including the read of the loss.
Reading the loss waits for the device only up to the loss; the optimizer
update of step k is finished before step k+1's forward runs, so the sum of
``s_per_step`` over steps 2..N covers N-1 full steps.

Not yet ported from ``repro.train.loop``: checkpoint/restart, preemption
handling, the resilience ladder, observability spans and metrics, controller
hooks and the prefetching data pipeline (batches are made on the device
inside the step's timing).
"""
from __future__ import annotations

import time

from .steps import TrainState


class Trainer:
    def __init__(self, *, train_step, init_state_fn, batch_fn,
                 log_every: int = 10):
        self.train_step = train_step
        self.init_state_fn = init_state_fn
        self.batch_fn = batch_fn
        self.log_every = log_every
        self.metrics_history: list[dict] = []

    def run(self, total_steps: int) -> TrainState:
        state = self.init_state_fn()
        history, window = [], []
        for step in range(state.step, total_steps):
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            state, metrics = self.train_step(state, batch)
            record = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            history.append({"step": step + 1, "s_per_step": dt, **record})
            window.append(dt)
            if (step + 1) % self.log_every == 0:
                print(f"[trainer] step {step + 1} loss "
                         f"{record['loss']:.4f} "
                         f"({sum(window) / len(window) * 1e3:.0f} ms/step)")
                window = []
        self.metrics_history = history
        return state
