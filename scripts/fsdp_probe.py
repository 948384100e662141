#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 22 (b) step on one CUDA card (an H100) in two
trees, for an A/B of the FSDP schedule and gloo's staging.

    python3 scripts/fsdp_probe.py [--parent DIR] [--order pnnp] [--steps 6]

Each run is the training CLI under torchrun at 2 gloo ranks sharing the
card, with phase 22 (b)'s arguments (phase 3's llama-350m configuration,
``--zero 1``, no checkpoints), from the root of a tree: ``n`` this
checkout, ``p`` the tree at ``--parent`` (a checkout of the parent commit,
e.g. unpacked by ``git archive`` into a directory ``.gitignore`` lists).
The kernel library is built once here and copied into the parent's build
directory (its sources are the same). Prints, a run a line, each rank's
losses, seconds a step, peak device memory (the run's, and the largest
step's where the tree records it) and the last step's collectives, then whether every run's
losses equal the first's bit for bit, with the card's name and power limit
first and last.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cli_run(tree: Path, steps: int) -> list[dict]:
    """One torchrun of phase 22 (b) from ``tree``: the ranks' lines."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    argv = [*chip_smoke.ZERO_CLI_ARGV, "--zero", "1", "--dist-backend",
            "gloo"]
    argv[argv.index("--steps") + 1] = str(steps)
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv],
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if run.returncode:
        raise RuntimeError(f"{tree}: exit {run.returncode}\n"
                           f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    ranks = sorted((json.loads(line.split("[train] rank ", 1)[1])
                    for line in run.stdout.splitlines()
                    if line.startswith("[train] rank ")),
                   key=lambda r: r["rank"])
    for r in ranks:
        r["wall_s"] = wall
    return ranks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--order", default="pnnp")
    ap.add_argument("--steps", type=int, default=6)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("fsdp_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import cuda_lib

    print(chip_smoke._device_line(), flush=True)
    lib = Path(cuda_lib.library()._name)
    parent = Path(opts.parent)
    if "p" in opts.order:
        dst = parent / "build" / "repro_torch_kernels"
        dst.mkdir(parents=True, exist_ok=True)
        shutil.copy2(lib, dst / lib.name)
    trees = {"n": ROOT, "p": parent}
    first = None
    same = []
    for i, t in enumerate(opts.order):
        ranks = cli_run(trees[t], opts.steps)
        losses = [r["losses"] for r in ranks]
        first = first or losses
        same.append(losses == first)
        print(json.dumps({
            "run": i, "tree": t, "losses": losses[0],
            "rank_ms_per_step_after_first": [
                sum(r["s_per_step"][1:]) / (len(r["s_per_step"]) - 1) * 1e3
                for r in ranks],
            "rank_s_per_step": [r["s_per_step"] for r in ranks],
            "rank_peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
            "rank_step_peak_memory_bytes": [
                r.get("step_peak_memory_bytes") for r in ranks],
            "rank_step_collectives": [
                r.get("step_collectives") for r in ranks],
            "wall_s": ranks[0]["wall_s"]}), flush=True)
    print(json.dumps({"losses_equal_to_first_run": same}), flush=True)
    print(chip_smoke._device_line(), flush=True)
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
