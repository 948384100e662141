#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 1 (the build) and 21 (the encoder-decoder and
cross-attention families: their kernels' shapes, serving and training)
alone, on one CUDA card (an H100), through its own functions.

    python3 scripts/encdec_probe.py [--parts abc] \
        [--train "ARCH:LAYERS:BATCH:SEQ;..."]

``--parts`` picks phase 21's parts: (a) the kernels at the families'
shapes, (b) serving, (c) training; all three (the default) run as the phase
does, with its wall time per part. ``--train`` adds training runs of ARCH
cut to LAYERS layers (``-`` for its own depth; kinds joined by commas,
``attn,cross``, for that pattern once) at batch BATCH x SEQ. A part
or run that raises (out of memory, a failed check) is reported with its
traceback and the probe goes on; it then exits 1. Prints what those parts
print, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="abc")
    ap.add_argument("--train", default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("encdec_probe: no CUDA device", file=sys.stderr)
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
        gc.collect()             # a failed run's tensors, held in cycles
        torch.cuda.empty_cache()

    if opts.parts == "abc":
        attempt("abc", chip_smoke.run_encdec_family, torch, dev)
    if "a" in opts.parts and opts.parts != "abc":
        attempt("a", chip_smoke.check_encdec_kernels, torch, dev)
    if "b" in opts.parts and opts.parts != "abc":
        attempt("b", chip_smoke.run_encdec_serving, torch, dev)
    runs = list(chip_smoke.ENCDEC_TRAIN_RUNS) \
        if "c" in opts.parts and opts.parts != "abc" else []
    for spec in (opts.train.split(";") if opts.train else []):
        arch, layers, batch, seq = spec.split(":")
        depth = (None if layers == "-" else int(layers) if
                 layers.isdigit() else tuple(layers.split(",")))
        runs.append((arch, depth, int(batch), int(seq)))
    for run in runs:
        attempt(f"train {run}", chip_smoke.run_encdec_training, torch, dev,
                [run])
    print(json.dumps({"encdec_phase_wall_s": time.perf_counter() - t0,
                      "failed": failed}), flush=True)
    print(chip_smoke._device_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
