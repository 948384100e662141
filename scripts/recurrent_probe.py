#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 1 (the build) and 20 (the recurrent families:
their kernels' shapes, serving and training) alone, on one CUDA card (an
H100), through its own functions.

    python3 scripts/recurrent_probe.py [--parts abc] \
        [--train "ARCH:LAYERS:BATCH;..."] [--prefill-once "ARCH:LAYERS:LEN"]

``--parts`` picks phase 20's parts: (a) the kernels at the families'
shapes, (b) serving, (c) training; all three (the default) run as the phase
does, with its wall time per part. ``--train`` adds training runs of ARCH
cut to LAYERS layers at batch BATCH x 512. A part or run that raises (out
of memory, a failed check) is reported with its traceback and the probe
goes on; it then exits 1. ``--prefill-once`` times one no-grad prefill of 2
prompts of LEN tokens (after a warm-up one), then profiles one more: its
device kernels' launches, busy time and idle share. Prints what those parts
print, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _prefill_once(torch, dev, chip_smoke, spec: str) -> None:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    arch, layers, length = spec.split(":")
    cfg = chip_smoke._config(arch, int(layers))
    params = T.cast_params(T.init_params(cfg, seed=0, device=dev), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, int(length)))).to(dev)
    with torch.inference_mode():
        T.prefill(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            T.prefill(params, {"tokens": tokens}, cfg)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    kernels, busy_ms = chip_smoke._device_kernels(prof)
    print(json.dumps({"prefill_once": spec, "wall_s": wall,
                      "device_kernel_launches": sum(e.count
                                                    for e in kernels),
                      "profiled_wall_s": prof_wall,
                      "device_busy_ms": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / 1e3 / prof_wall,
                      "top_device_kernels": chip_smoke._top(kernels, 5),
                      "device": chip_smoke._device_line()}), flush=True)
    del params
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="abc")
    ap.add_argument("--train", default=None)
    ap.add_argument("--prefill-once", default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("recurrent_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import cuda_lib

    print(chip_smoke._device_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cuda_lib.library()
    print(json.dumps({"kernel_build_s": time.perf_counter() - t0}),
          flush=True)
    t0 = time.perf_counter()
    failed = []

    def attempt(label, fn, *args):
        """A part that raises is reported with its traceback and the probe
        goes on to the next; the exit code says that one failed."""
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 - a diagnostic probe, reported
            failed.append(label)
            print(json.dumps({"failed": label,
                              "traceback": traceback.format_exc()[-3000:]}),
                  flush=True)
            torch.cuda.empty_cache()

    for spec in (opts.prefill_once.split(";") if opts.prefill_once else []):
        attempt(f"prefill-once {spec}", _prefill_once, torch, dev,
                chip_smoke, spec)
    if opts.parts == "abc":
        attempt("abc", chip_smoke.run_recurrent_family, torch, dev)
    if "a" in opts.parts and opts.parts != "abc":
        attempt("a", chip_smoke.check_recurrent_kernels, torch, dev)
    if "b" in opts.parts and opts.parts != "abc":
        attempt("b", chip_smoke.run_recurrent_serving, torch, dev)
    runs = list(chip_smoke.RECURRENT_TRAIN_RUNS) \
        if "c" in opts.parts and opts.parts != "abc" else []
    for spec in (opts.train.split(";") if opts.train else []):
        arch, layers, batch = spec.split(":")
        runs.append((arch, int(layers), int(batch)))
    for run in runs:
        attempt(f"train {run}", chip_smoke.run_recurrent_training, torch,
                dev, [run])
    print(json.dumps({"recurrent_phase_wall_s": time.perf_counter() - t0,
                      "failed": failed}), flush=True)
    print(chip_smoke._device_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
