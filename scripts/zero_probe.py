#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 22 (ZeRO-1 at world 2 on one card) alone, on
one CUDA card (an H100), through its own functions, with two checks the
phase does not make.

    python3 scripts/zero_probe.py [--parts gabc] [--ab]

``--parts``: (g) which ``gloo`` collectives take CUDA tensors on this
torch: two spawned ranks try each on a CUDA tensor and report the result
or the error; (b) the CLI under torchrun, after phase 3's run for its
losses; (a) phase 22's part (a), the API, with the column statistic
completed from the kernel's row-block partials (the default); (c) the
checkpoint resharded (needs (b); its ranks' half runs in (a)'s spawn).
``--ab`` also runs (a) with the column statistic completed as the
reference does (each shard's column totals summed across the shards, its
``psum``: ``totals_rank`` patches the step's ``allsum_row_blocks`` in the
ranks) in the same call, without its checks, and prints how many
selections of each run differ from the replicated run's. A part that raises is reported
with its traceback and the probe goes on; it then exits 1. Prints the
card's name and power limit first.
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
GLOO_DIR = ROOT / "build" / "zero_probe_gloo"
# (name, call on a CUDA tensor ``t`` of 8 floats, a world of 2)
GLOO_OPS = (
    ("all_reduce", lambda dist, torch, t: dist.all_reduce(t)),
    ("all_gather", lambda dist, torch, t: dist.all_gather(
        [torch.empty_like(t) for _ in range(2)], t)),
    ("all_gather_into_tensor", lambda dist, torch, t:
        dist.all_gather_into_tensor(torch.empty(16, device=t.device), t)),
    ("broadcast", lambda dist, torch, t: dist.broadcast(t, 0)),
    ("reduce_scatter_tensor", lambda dist, torch, t:
        dist.reduce_scatter_tensor(torch.empty(4, device=t.device), t)),
    ("all_to_all_single", lambda dist, torch, t: dist.all_to_all_single(
        torch.empty_like(t), t)),
    ("gather", lambda dist, torch, t: dist.gather(
        t, [torch.empty_like(t) for _ in range(2)]
        if dist.get_rank() == 0 else None, dst=0)),
)


def gloo_rank(rank: int) -> None:
    """One rank of (g): each op of ``GLOO_OPS`` on a CUDA tensor."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{GLOO_DIR / 'pg'}",
                            rank=rank, world_size=2)
    out = {}
    for name, fn in GLOO_OPS:
        t = torch.full((8,), float(rank + 1), device="cuda")
        try:
            fn(dist, torch, t)
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the probe reports each
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
        dist.barrier()
    (GLOO_DIR / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def totals_rank(rank: int, task: str, restore: bool = False) -> None:
    """A rank of (a) whose sharded leaves complete the column statistic
    from each shard's column totals (the kernel's own norms, the ordered
    sum of its row-block partials), summed across the shards in shard
    order, in place of all the shards' partials summed in order."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import fused_step, selection

    def totals(partial, axes):
        return selection.allsum(selection.allsum_row_blocks(partial, ()),
                                axes)

    fused_step.allsum_row_blocks = totals
    chip_smoke.zero_rank(rank, task, restore)


def gloo_collectives(torch) -> None:
    import multiprocessing
    import shutil

    shutil.rmtree(GLOO_DIR, ignore_errors=True)
    GLOO_DIR.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank, args=(r,)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    print(json.dumps({"gloo_cuda_collectives": json.loads(
        (GLOO_DIR / "rank0.json").read_text()),
        "torch": torch.__version__}), flush=True)
    shutil.rmtree(GLOO_DIR, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="gabc")
    ap.add_argument("--ab", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("zero_probe: no CUDA device", file=sys.stderr)
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
    failed = []

    def attempt(label, fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except Exception:  # noqa: BLE001 - a diagnostic probe, reported
            failed.append(label)
            print(json.dumps({"failed": label,
                              "traceback": traceback.format_exc()[-3000:]}),
                  flush=True)
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    if "g" in opts.parts:
        attempt("g", gloo_collectives, torch)
    cli = None
    if "b" in opts.parts:
        counts, main_losses = chip_smoke.run_main_path(torch)
        cli = attempt("b", chip_smoke.run_zero_cli, torch, main_losses)
    restore = "c" in opts.parts and cli is not None
    api = None
    if "a" in opts.parts or restore:
        api = attempt("a", chip_smoke.run_zero_api, torch, restore=restore)
    if opts.ab:
        attempt("a totals", chip_smoke.run_zero_api, torch, check=False,
                target=totals_rank)
    if restore and api is not None:
        attempt("c", chip_smoke.run_zero_restore, torch, cli, api[1])
    print(json.dumps({"probe_wall_s": time.perf_counter() - t0,
                      "failed": failed}), flush=True)
    print(chip_smoke._device_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
