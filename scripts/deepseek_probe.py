#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 1 (the build) and 19 (the DeepSeek MoE family:
its kernels' shapes, serving and training) alone, on one CUDA card (an
H100), through its own functions.

    python3 scripts/deepseek_probe.py [--parts abc] \
        [--train-layers "ARCH:A,B:BATCH;..."]

``--parts`` picks phase 19's parts: (a) the kernels at the family's shapes,
(b) serving, (c) training. ``--train-layers`` adds training runs of ARCH
with A layers of its first schedule segment and B of its second at batch
BATCH x 512. Each training run that runs out of memory is reported
instead of failing the probe. Prints what those parts print, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="abc")
    ap.add_argument("--train-layers", default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("deepseek_probe: no CUDA device", file=sys.stderr)
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
    if "a" in opts.parts:
        chip_smoke.check_moe_kernels(torch, dev)
    if "b" in opts.parts:
        chip_smoke.run_moe_serving(torch, dev)
    runs = list(chip_smoke.MOE_TRAIN_RUNS) if "c" in opts.parts else []
    if opts.train_layers:
        for spec in opts.train_layers.split(";"):
            arch, layers, batch = spec.split(":")
            runs.append((arch, tuple(int(x) for x in layers.split(",")),
                         int(batch)))
    for run in runs:
        try:
            chip_smoke.run_moe_training(torch, dev, [run])
        except torch.cuda.OutOfMemoryError as err:
            print(json.dumps({"moe_training": list(run),
                              "out_of_memory": str(err)[:400]}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"moe_phase_wall_s": time.perf_counter() - t0}),
          flush=True)
    print(chip_smoke._device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
