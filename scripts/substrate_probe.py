#!/usr/bin/env python3
"""What the training substrate costs a step, on one CUDA card (an H100).

    python3 scripts/substrate_probe.py [--rounds 4]
    python3 scripts/substrate_probe.py --phase15

Default: the guarded step's cost split into its parts. llama-350m at full
width and depth, DCT-AdamW rank 128, batch 8 x 512, the training CLI's
schedule (lr 0.01, cosine warmup 2 of 6 steps), 6 steps a run through the
``Trainer``, in rounds that rotate the order of five variants:

  plain      the CLI's defaults
  resilient  ``--resilient``: the guard, the ladder and ``lr_scale``
  guard      ``make_train_step(guard=True)`` alone
  lr_scale   ``lr_scale=True`` alone (one more multiply per update leaf)
  sync       plain, with ``torch.cuda.synchronize()`` after each step: the
             guard's wait for the whole step without its checks

Every run's losses must equal the first plain run's bit for bit. Prints one
JSON line per run (the mean ``s_per_step`` of steps 2-6, peak memory), then
per variant the median over rounds and its ratio to plain's, and the card's
name and power limit.

``--phase15``: ``chip_smoke.py``'s phases 1 (the build), 3 (the main path)
and 15 (the training substrate) alone, through its own functions.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ, RANK = 6, 8, 512, 128
VARIANTS = ("plain", "resilient", "guard", "lr_scale", "sync")


def _trainer(torch, variant: str, dev):
    """A ``Trainer`` built as the training CLI builds one, with the
    variant's options."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.train.loop import Trainer
    from repro_torch.train.resilience import ResilienceManager
    from repro_torch.train.schedule import cosine_warmup
    from repro_torch.train.steps import init_state, make_train_step

    cfg = get_config("llama-350m")
    opt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, STEPS),
                        rank=RANK, weight_decay=0.01,
                        lr_scale=variant in ("resilient", "lr_scale"))
    step = make_train_step(cfg, opt, guard=variant in ("resilient", "guard"))
    if variant == "sync":
        inner = step

        def step(state, batch):
            out = inner(state, batch)
            torch.cuda.synchronize()
            return out
    return Trainer(train_step=step,
                   init_state_fn=lambda: init_state(cfg, opt, 0, dev),
                   batch_fn=make_batch_fn(cfg, SEQ, BATCH, device=dev),
                   log_every=10 * STEPS, log_fn=lambda s: None,
                   resilience=(ResilienceManager(log_fn=print)
                               if variant == "resilient" else None))


def guard_split(torch, rounds: int, dev) -> None:
    results = {v: [] for v in VARIANTS}
    want = None
    for r in range(rounds):
        order = VARIANTS[r % len(VARIANTS):] + VARIANTS[:r % len(VARIANTS)]
        for variant in order:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer = _trainer(torch, variant, dev)
            trainer.run(total_steps=STEPS)
            torch.cuda.synchronize()
            hist = trainer.metrics_history
            losses = [h["loss"] for h in hist]
            want = want or losses
            if losses != want:
                raise AssertionError(f"{variant}: losses {losses} != {want}")
            ms = sum(h["s_per_step"] for h in hist[1:]) / (STEPS - 1) * 1e3
            results[variant].append(ms)
            print(json.dumps({"round": r, "variant": variant,
                              "ms_per_step_after_first": ms,
                              "max_memory_allocated_bytes":
                                  torch.cuda.max_memory_allocated()}),
                  flush=True)
            del trainer
    plain = statistics.median(results["plain"])
    print(json.dumps({"median_ms_per_step": {
        v: statistics.median(ms) for v, ms in results.items()},
        "over_plain": {v: statistics.median(ms) / plain
                       for v, ms in results.items()},
        "runs": results}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--phase15", action="store_true")
    opts = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("substrate_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import cuda_lib

    print(chip_smoke._device_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.library()
    print(json.dumps({"kernel_build_s": time.perf_counter() - t0}),
          flush=True)
    if opts.phase15:
        _, losses = chip_smoke.run_main_path(torch)
        torch.cuda.empty_cache()
        chip_smoke.run_substrate(torch, torch.device("cuda"), losses)
    else:
        guard_split(torch, opts.rounds, torch.device("cuda"))
    print(chip_smoke._device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
