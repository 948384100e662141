#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 1 (the build), 3 (the main path) and 18 (the
legacy harness, the fused-mode default, the op aliases and the serving
CLI's ``--metrics``) alone, on one CUDA card (an H100), through its own
functions.

    python3 scripts/runtime_probe.py

Prints what those phases print, then the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("runtime_probe: no CUDA device", file=sys.stderr)
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
    _, losses = chip_smoke.run_main_path(torch)
    torch.cuda.empty_cache()
    chip_smoke.run_runtime(torch, torch.device("cuda"), losses)
    print(chip_smoke._device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
