#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 1 (the build) and 17 (the dense
configurations qwen2.5-32b, phi3-mini-3.8b and command-r-plus-104b: their
kernels' shapes, serving and training) alone, on one CUDA card (an H100),
through its own functions.

    python3 scripts/dense_configs_probe.py [--parts abc] [--update-depth N]

``--parts`` picks phase 17's parts: (a) the kernels at the
configurations' shapes, (b) serving, (c) training; ``--update-depth``
sets the depth of (c)'s optimizer update alone (32: phi3-mini-3.8b's
full depth). Prints what those parts print, then the card's name and power
limit.
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
    ap.add_argument("--update-depth", type=int, default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("dense_configs_probe: no CUDA device", file=sys.stderr)
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
    if "a" in opts.parts:
        chip_smoke.check_config_kernels(torch, dev)
    if "b" in opts.parts:
        chip_smoke.run_config_serving(torch, dev)
    if "c" in opts.parts:
        chip_smoke.run_config_training(torch, dev, opts.update_depth)
    print(chip_smoke._device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
