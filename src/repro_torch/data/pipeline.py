"""Host-side data pipeline with prefetch and straggler mitigation, as in
``repro/data/pipeline.py``.

Data is deterministic in (seed, step), so any batch can be recomputed. The
pipeline prefetches ``depth`` batches on a thread, and ``get`` has a
timeout: a batch that misses it (a straggler) is recomputed inline, bit for
bit the batch the worker would have made. A ``batch_fn`` exception is
retried on the worker with capped exponential backoff (``retries``
attempts); a persistent failure is recorded and re-raised from the
caller's ``get``.

CUDA: the port's batches are made on the card (``data/synthetic.py``). The
worker thread launches them on its current stream, which is the device's
default stream (PyTorch gives a new thread no stream of its own), the
stream the train step runs on. So a prefetched batch's kernels and copies
are ordered with the step's kernels, and the consumer needs no
``wait_stream`` / ``record_stream``.
"""
from __future__ import annotations

import queue
import threading
import time


class DataPipeline:
    def __init__(self, batch_fn, start_step: int = 0, depth: int = 2,
                 timeout_s: float = 30.0, retries: int = 2,
                 retry_backoff_s: float = 0.05):
        self._fn = batch_fn
        self._timeout = timeout_s
        self._retries = retries
        self._backoff = retry_backoff_s
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._error: tuple[int, Exception] | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            delay = self._backoff
            for attempt in range(self._retries + 1):
                try:
                    batch = self._fn(step)
                    break
                except Exception as e:
                    if attempt == self._retries:
                        # persistent: surface through get(), don't vanish
                        self._error = (step, e)
                        return
                    print(f"[data] batch_fn failed at step {step} "
                          f"(attempt {attempt + 1}/{self._retries + 1}: "
                          f"{type(e).__name__}: {e}); retrying in "
                          f"{delay:.2f}s")
                    if self._stop.wait(delay):
                        return
                    delay = min(delay * 2, 1.0)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def _raise_worker_error(self):
        step, exc = self._error
        raise RuntimeError(
            f"data pipeline worker failed permanently at step {step} "
            f"after {self._retries + 1} attempts") from exc

    def get(self, step: int):
        """The batch for ``step``; recomputed inline on a timeout or a
        sequence mismatch (a restart elsewhere in the stream); raises if the
        worker died on a persistent ``batch_fn`` error."""
        deadline = time.monotonic() + self._timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break                   # straggler: recompute inline
            try:
                got_step, batch = self._q.get(
                    timeout=min(0.25, remaining))
            except queue.Empty:
                if self._error is not None:
                    self._raise_worker_error()
                continue
            if got_step == step:
                return batch
            break                       # sequence mismatch: recompute
        if self._error is not None:
            self._raise_worker_error()
        return self._fn(step)           # deterministic fallback

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
