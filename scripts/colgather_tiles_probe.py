#!/usr/bin/env python3
"""Build the fp32 colgather with other tile constants and time each build on
one CUDA card at llama-350m's shapes.

    python3 scripts/colgather_tiles_probe.py

Each variant is a copy of ``src/repro_torch/csrc/colgather_matmul.cu`` with
some of its ``f32`` constants replaced (thread rows ``TY`` and columns
``TX``, columns per thread ``TN``, the k slice ``BK``, the CTAs per SM the
launch bounds ask for ``kMinBlocks``), built with ``nvcc`` into
``build/colgather_tiles_probe/<variant>/`` (the copy step of
``scripts/ns_apply_tiles_probe.py``) and called through its C entry
points. Every variant sums each output's k terms in the same order, so
each must give the first variant's bits. Per DCT-AdamW step (7 launches: 4
at b (24, 1024, 128), 3 at (24, 2816, 128), Q^T (1024, 1024)) the dual and
the single as eager CUDA events, with TFLOP/s and ptxas' registers and
spills. Prints one JSON line per variant and the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "colgather_tiles_probe"

# name -> the f32 constants that differ from the source's
VARIANTS = {
    "source (TY 16, TX 16, TN 8, BK 16, 2 CTAs/SM)": {},
    "TN 16: 128 x 256, 1 CTA/SM": {"TN": 16, "kMinBlocks": 1},
    "TN 16, TX 8: 128 x 128, 128 threads, 2 CTAs/SM": {"TN": 16, "TX": 8},
    "TN 16, TY 8: 64 x 256, 128 threads, 2 CTAs/SM": {"TN": 16, "TY": 8},
    "BK 32": {"BK": 32},
    "BK 8": {"BK": 8},
    "TY 32: 256 x 128, 512 threads, 1 CTA/SM": {"TY": 32, "kMinBlocks": 1},
}


def _load(d: Path, proc) -> tuple[ctypes.CDLL, list[str]]:
    """The variant's library and ptxas' report of its fp32 kernels."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {d.name}:\n{log}")
    ptxas, inst = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"f3223colgather_matmul_kernelILi(\d)ELi(\d)E", line)
            inst = found and f"ops={found.group(1)} W={found.group(2)}"
        elif inst and ("spill" in line or "registers" in line):
            ptxas.append(f"{inst}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_colgather_matmul_dual.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
    lib.repro_colgather_matmul.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.repro_colgather_matmul_dual.restype = I
    lib.repro_colgather_matmul.restype = I
    return lib, ptxas


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]
    import torch

    if not torch.cuda.is_available():
        print("colgather_tiles_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ns_apply_tiles_probe import _compile

    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.selection import select_top_r
    from repro_torch.kernels import colgather_matmul as cg

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for (nb, m, n), per_step in cs.MAIN_SHAPES:
        qt = dct2_matrix(n, device="cuda").T.contiguous()
        idx = select_top_r(torch.rand((nb, n), generator=gen, device="cuda"), cs.RANK)
        b1 = torch.randn((nb, m, cs.RANK), generator=gen, device="cuda")
        b2 = torch.randn((nb, m, cs.RANK), generator=gen, device="cuda")
        cases.append((b1, b2, qt, idx, per_step,
                      cg.colgather_matmul_dual_plain(b1, b2, qt, idx)))
    builds = {name: _compile(name, consts, "colgather_matmul.cu", "f32", OUT)
              for name, consts in VARIANTS.items()}
    first = None
    for name, build in builds.items():
        lib, ptxas = _load(*build)
        outs, step, flops = [], {"dual": 0.0, "single": 0.0}, 0.0
        for b1, b2, qt, idx, per_step, want in cases:
            nb, m, r = b1.shape
            n = qt.shape[0]
            o1, o2, o = (torch.empty((nb, m, n), device="cuda") for _ in range(3))
            stream = torch.cuda.current_stream().cuda_stream

            def dual():
                assert lib.repro_colgather_matmul_dual(
                    b1.data_ptr(), b2.data_ptr(), qt.data_ptr(), idx.data_ptr(),
                    o1.data_ptr(), o2.data_ptr(), nb, m, r, n, stream) == 0

            def single():
                assert lib.repro_colgather_matmul(
                    b1.data_ptr(), qt.data_ptr(), idx.data_ptr(), o.data_ptr(), nb, m,
                    r, n, stream) == 0
            dual()
            single()
            torch.cuda.synchronize()
            assert max(cs._rel(o1, want[0]), cs._rel(o2, want[1])) <= 1e-5, name
            assert torch.equal(o, o1), name
            outs += [o1.clone(), o2.clone()]
            step["dual"] += per_step * cs._time_ms(dual)
            step["single"] += per_step * cs._time_ms(single)
            flops += per_step * 2.0 * nb * m * n * r
        first = first or outs
        print(json.dumps({
            "variant": name, "ms_per_step": step,
            "tflop_per_s": {"dual": 2 * flops / step["dual"] / 1e9,
                            "single": flops / step["single"] / 1e9},
            "same_bits_as_first": all(map(torch.equal, outs, first)),
            "ptxas": ptxas}), flush=True)
    print(cs._device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
