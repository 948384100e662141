#!/usr/bin/env python3
"""Time ``flash_decode`` and the fp32 ``flash_attention`` of one source tree
on one CUDA card, each held to its plain version first.

    python3 scripts/attention_kernels_probe.py [--tree DIR] [--label NAME]

``--tree`` names another checkout (for example a parent commit unpacked
with ``git archive`` into ``build/``) whose ``src/repro_torch`` is imported
in place of this one's; the shapes, inputs and timers are this checkout's
``chip_smoke.py`` helpers, which use only the wrappers' public signatures.
To compare two trees on one card, run them in turns in one command (A, B,
B, A): the kernels of each tree build into its own ``build/``.

Prints one JSON line per measurement and a ``probe_summary`` line:

* ``flash_decode`` at the serving shape of ``chip_smoke.py`` phase 5 (8
  slots, 16 heads of 64, block 16, bf16 pools, lengths 1-2048): per call
  at 1, 2, 4, 8 and 16 splits, the per-decode-step time (24 calls at 2
  splits), SDPA on the K/V densified through the table (gather not
  counted) and the byte bound, as device time of CUDA-graph replays
  (``chip_smoke._graph_ms``), and the eager per-call time with the
  wrapper's host work; and at gemma3-27b's local-layer decode
  shape (4 slots, 32 / 16 heads of 128, window 1024, lengths 512-2080).
* ``flash_attention`` on fp32 inputs at phase 12's cases (a)-(c), beside
  fp32 SDPA and its bounds (``chip_smoke._fa_fp32_case``), and per
  llama-350m prefill (24 calls at (a)).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _decode_timing(torch, cs, fd, dev, name, args, splits, window=None):
    q, k, v, table, ln = args
    q = q.to(torch.bfloat16)
    err = max(cs._fd_compare(torch, fd, args, qd, sp, window)
              for qd in (torch.float32, torch.bfloat16) for sp in splits)

    def call(sp):
        return lambda: fd.flash_decode(q, k, v, table, ln, window=window,
                                       num_splits=sp)
    # device time (CUDA-graph replays of a decode step's 24 calls), and
    # eager calls with the wrapper's host work
    per_split = {sp: cs._graph_ms(call(sp), cs.LAYERS) for sp in splits}
    eager = cs._time_ms(call(cs.NUM_SPLITS))
    b, hq, hd = q.shape
    hkv, bs = k.shape[2], k.shape[1]
    lens = ln.tolist()
    lo = [max(0, n - window) if window else 0 for n in lens]
    tokens = sum(n - a for n, a in zip(lens, lo))
    # the valid K/V rows, q in and out, the table entries of the run
    # blocks, the lengths
    blocks = sum(-(-n // bs) - a // bs for n, a in zip(lens, lo) if n)
    nbytes = (tokens * hkv * hd * k.element_size() * 2 + 2 * q.numel() * 2
              + blocks * 4 + b * 4)
    bound, by = cs._bound_ms(nbytes, 4.0 * tokens * hq * hd)
    lib_ms = cs._graph_ms(cs._fd_sdpa(torch, q, k, v, table, ln, window),
                          cs.LAYERS)
    out = {"flash_decode_shape": name, "slots": b, "heads": [hq, hkv],
           "hd": hd, "block": bs, "window": window, "lengths": lens,
           "max_abs_err": err, "per_call_ms_by_splits": per_split,
           "wrapper_per_call_ms": eager,
           "sdpa_per_call_ms_gather_not_counted": lib_ms,
           "bound_per_call_ms": bound, "bound_by": by, "bytes": nbytes}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("attention_kernels_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    assert Path(cuda_lib.__file__).resolve().is_relative_to(tree), \
        cuda_lib.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    label = args.label or str(tree)
    print(json.dumps({"probe": label, "card": cs._device_line()}), flush=True)
    cuda_lib.library()
    print("\n".join(line for line in cuda_lib.build_log().splitlines()
                    if "flash" in line and ("registers" in line
                                            or "spill" in line)), flush=True)

    bf16 = torch.bfloat16
    lens = np.linspace(1, cs.MAX_BLOCKS * cs.BLOCK, cs.SLOTS).astype(int)
    serving = _decode_timing(
        torch, cs, fd, dev, "llama-350m serving",
        cs._fd_case(torch, dev, 0, b=cs.SLOTS, hq=cs.HEADS, hkv=cs.HEADS,
                    hd=cs.HEAD_DIM, bs=cs.BLOCK, maxb=cs.MAX_BLOCKS,
                    lengths=lens.tolist(), kv_dtype=bf16),
        (1, 2, 4, 8, 16))
    gemma_lens = np.linspace(512, 2080, 4).astype(int).tolist()
    gemma = _decode_timing(
        torch, cs, fd, dev, "gemma3-27b local layer",
        cs._fd_case(torch, dev, 1, b=4, hq=32, hkv=16, hd=128, bs=cs.BLOCK,
                    maxb=-(-2080 // cs.BLOCK), lengths=gemma_lens,
                    kv_dtype=bf16),
        (1, 2, 16), window=1024)

    cases = {}
    for i, (name, (b, s, hq, hkv, hd, window, _)) in enumerate(
            cs.FA_CASES.items()):
        cases[name] = cs._fa_fp32_case(torch, dev, fa, i, b, s, hq, hkv, hd,
                                       window)
        print(json.dumps({"flash_attention_case": name, **cases[name]}),
              flush=True)
    a = cases[next(iter(cs.FA_CASES))]
    print(json.dumps({
        "probe_summary": label, "card": cs._device_line(),
        "flash_decode_ms_per_decode_step": cs.LAYERS
        * serving["per_call_ms_by_splits"][cs.NUM_SPLITS],
        "flash_decode_wrapper_ms_per_decode_step": cs.LAYERS
        * serving["wrapper_per_call_ms"],
        "flash_decode_split_sweep_ms": serving["per_call_ms_by_splits"],
        "flash_decode_sdpa_ms_per_decode_step": cs.LAYERS
        * serving["sdpa_per_call_ms_gather_not_counted"],
        "flash_decode_bound_ms_per_decode_step": cs.LAYERS
        * serving["bound_per_call_ms"],
        "flash_decode_gemma3_local_per_call_ms":
            gemma["per_call_ms_by_splits"][cs.NUM_SPLITS],
        "flash_attention_fp32_ms_per_llama_prefill": cs.LAYERS * a["ms"],
        "flash_attention_fp32_sdpa_ms_per_llama_prefill": cs.LAYERS
        * a["library_ms"],
        "flash_attention_fp32_bound_ms_per_llama_prefill": cs.LAYERS
        * a["bound_ms"],
        "flash_attention_fp32_simt_bound_ms_per_llama_prefill": cs.LAYERS
        * a["fp32_simt_bound_ms"],
        "flash_attention_fp32_ms_by_case": {n: c["ms"]
                                            for n, c in cases.items()},
        "flash_attention_fp32_sdpa_ms_by_case": {
            n: c["library_ms"] for n, c in cases.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
