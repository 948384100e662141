"""Restart supervisor for the training CLI, as in
``repro/train/supervisor.py``.

Runs the training entry point in a child process; on a non-zero exit (a
crash, an OOM, a killed node) it restarts it, and the child resumes from
the latest verified checkpoint, with capped exponential backoff and a
restart budget. ``progress_fn`` (typically :func:`checkpoint_progress_fn`
over the run's checkpoint directory) is sampled before and after every
attempt: the budget resets whenever the checkpoint step advanced, and
``crash_loop_limit`` consecutive restarts without progress halt the
supervisor. A child exiting with
:data:`~repro_torch.train.resilience.HALT_EXIT_CODE` has diagnosed its
failure as deterministic (ladder rung 4) and is never restarted.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from typing import Callable

from .resilience import HALT_EXIT_CODE


def checkpoint_progress_fn(ckpt_dir: str) -> Callable[[], int | None]:
    """A ``progress_fn`` reading the latest published checkpoint step in
    ``ckpt_dir`` (a directory scan: no verification, the child verifies on
    restore)."""

    def fn() -> int | None:
        try:
            names = os.listdir(ckpt_dir)
        except FileNotFoundError:
            return None
        steps = [int(m.group(1)) for name in names
                 if (m := re.fullmatch(r"step_(\d+)", name))
                 and os.path.exists(os.path.join(ckpt_dir, name, "OK"))]
        return max(steps) if steps else None
    return fn


def supervise(cmd: list[str], *, max_restarts: int = 10,
              backoff_s: float = 2.0, max_backoff_s: float = 60.0,
              log=print, progress_fn: Callable[[], int | None] | None = None,
              crash_loop_limit: int = 3) -> int:
    """Run ``cmd`` until it exits 0 or the policy above gives up; returns
    the last exit code."""
    attempt = 0
    no_progress = 0
    while True:
        before = progress_fn() if progress_fn is not None else None
        if progress_fn is not None:
            log(f"[supervisor] resume context: latest checkpoint step "
                f"{before if before is not None else '<none>'}")
        log(f"[supervisor] launching (attempt {attempt + 1}): {' '.join(cmd)}")
        proc = subprocess.run(cmd)
        after = progress_fn() if progress_fn is not None else None
        if proc.returncode == 0:
            log("[supervisor] clean exit")
            return 0
        if proc.returncode == HALT_EXIT_CODE:
            log(f"[supervisor] child halted deliberately (exit "
                f"{HALT_EXIT_CODE}: escalation ladder exhausted) — "
                f"not restarting")
            return proc.returncode
        if progress_fn is not None:
            log(f"[supervisor] child exited {proc.returncode}; checkpoint "
                f"step {before if before is not None else '<none>'} -> "
                f"{after if after is not None else '<none>'}")
            if after is not None and (before is None or after > before):
                if attempt or no_progress:
                    log("[supervisor] checkpoint advanced — restart "
                        "budget reset")
                attempt = 0
                no_progress = 0
            else:
                no_progress += 1
                if no_progress >= crash_loop_limit:
                    log(f"[supervisor] crash loop: {no_progress} restarts "
                        f"without checkpoint progress — halting")
                    return proc.returncode
        attempt += 1
        if attempt > max_restarts:
            log(f"[supervisor] giving up after {max_restarts} restarts")
            return proc.returncode
        delay = min(backoff_s * (2 ** (attempt - 1)), max_backoff_s)
        log(f"[supervisor] exit code {proc.returncode}; restarting from "
            f"latest checkpoint in {delay:.0f}s")
        time.sleep(delay)


def main():
    """``python -m repro_torch.train.supervisor <command> [args...]``."""
    sys.exit(supervise(sys.argv[1:]))


if __name__ == "__main__":
    main()
