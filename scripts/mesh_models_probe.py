#!/usr/bin/env python3
"""``chip_smoke.py``'s checks of the models' mesh bodies alone, on one CUDA
card (an H100), through its own functions.

    python3 scripts/mesh_models_probe.py [--parts ok]

``--parts``: (o) phase 12's query slices at an offset (both prefill
kernels, ``OFFSET_CASES``) and their times at the SP prefill's shape; (k)
phase 22's parts (d)-(g) on two spawned ranks sharing the card over
``gloo``: deepseek-moe-16b's DCT-AdamW step expert-parallel on (1, 2) and
routed as one batch on ``("data",)``, its ``decode_tp`` decode on (1, 2)
and (2, 1), qwen2.5-32b's sequence-parallel prefill and a llama-350m step
with ``attn_sp``, each held to one process. A part that raises is reported
with its traceback and the probe goes on; it then exits 1. Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def mesh_rank(rank: int, task: str, restore: bool = False) -> None:
    """One rank of (k): gloo from a file store, parts (d)-(g), its result
    as ``chip_smoke.zero_rank`` writes it."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    cs = _chip_smoke()
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{cs.ZERO_DIR / (task + '.pg')}",
            rank=rank, world_size=cs.ZERO_WORLD)
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((cs.ZERO_WORLD,), ("data",))
        out = {"rank": rank, "mesh_models": cs._mesh_models(torch, mesh)}
        (cs.ZERO_DIR / f"{task}.rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()
    except BaseException:
        (cs.ZERO_DIR / f"{task}.rank{rank}.err").write_text(
            traceback.format_exc())
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="ok")
    opts = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("mesh_models_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    print(cs._device_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import cuda_lib

    cuda_lib.library()
    dev = torch.device("cuda")
    failed = False
    for part in opts.parts:
        t0 = time.perf_counter()
        try:
            if part == "o":
                cs.check_attention_offsets(torch, dev)
            elif part == "k":
                ranks = cs.spawn_zero_ranks("mesh", target=mesh_rank)
                cs._check_mesh_models([r["mesh_models"] for r in ranks])
            else:
                raise ValueError(f"unknown part {part!r}")
        except BaseException:  # noqa: BLE001 - report and go on
            failed = True
            print(f"part {part} failed:\n{traceback.format_exc()}",
                  flush=True)
        print(json.dumps({"part": part, "wall_s": time.perf_counter() - t0}),
              flush=True)
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
