#!/usr/bin/env python3
"""Build ``ns_apply`` with other tile constants and time each build on one
CUDA card at Trion's shapes.

    python3 scripts/ns_apply_tiles_probe.py

Each variant is a copy of ``src/repro_torch/csrc/newton_schulz.cu`` with
some of its ``apply`` constants replaced (columns per CTA ``BN``, columns
per thread ``TN``, the k slice ``BK``, the CTAs per SM the launch bounds
ask for ``kMinBlocks``), built with ``nvcc`` into
``build/ns_apply_tiles_probe/<variant>/`` and called through its C entry
point. Every variant sums each output's k terms in the same order, so each
must give the first variant's bits. Per Trion step of llama-350m (20
launches at the wide factor (24, 128, 1024), 15 at (24, 128, 2816)) as
device time of CUDA-graph replays, with ptxas' registers and spills. Prints
one JSON line per variant and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ns_apply_tiles_probe"

# name -> the apply constants that differ from the source's
VARIANTS = {
    "source (BN 64, TN 8, BK 16, 3 CTAs/SM)": {},
    "2 CTAs/SM": {"kMinBlocks": 2},
    "BK 8, 4 CTAs/SM": {"BK": 8, "kMinBlocks": 4},
    "BK 32, 2 CTAs/SM": {"BK": 32, "kMinBlocks": 2},
    "BN 128, 256 threads, 2 CTAs/SM": {"BN": 128, "kMinBlocks": 2},
    "BN 128, TN 16, 2 CTAs/SM": {"BN": 128, "TN": 16, "kMinBlocks": 2},
}


def _compile(name: str, consts: dict, source: str = "newton_schulz.cu",
             namespace: str = "apply", out: Path = OUT
             ) -> tuple[Path, subprocess.Popen]:
    """Write the variant's source (``consts`` replacing the ``constexpr
    int`` lines of ``namespace``) and start its nvcc."""
    text = (CSRC / source).read_text()
    head, rest = text.split(f"namespace {namespace} {{", 1)
    for key, value in consts.items():
        old = next(line for line in rest.splitlines()
                   if line.startswith(f"constexpr int {key} = "))
        rest = rest.replace(old, f"constexpr int {key} = {value};", 1)
    d = out / "".join(ch if ch.isalnum() else "_" for ch in name)
    d.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    (d / source).write_text(head + f"namespace {namespace} {{" + rest)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return d, subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(d / "lib.so"),
         str(d / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(d: Path, proc: subprocess.Popen) -> tuple[ctypes.CDLL, list[str]]:
    """The variant's library and ptxas' report of its apply kernel."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {d.name}:\n{log}")
    # ptxas reports each kernel as a "Compiling entry function" line, then
    # its spills and its registers: those of the apply kernel's two
    # instances, W = 4 (16-byte copies) and W = 1
    ptxas, width = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"ns_apply_kernelILi(\d+)E", line)
            width = found and found.group(1)
        elif width and ("spill" in line or "registers" in line):
            ptxas.append(f"W={width}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_ns_apply.argtypes = [P, P, P, ctypes.c_float, I, I, I, P]
    lib.repro_ns_apply.restype = I
    return lib, ptxas


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("ns_apply_tiles_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    from repro_torch.core.newton_schulz import NS_COEFFS
    from repro_torch.kernels import newton_schulz as ns

    torch.backends.cuda.matmul.allow_tf32 = False
    a, b, c = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for (nb, m, _), per_step in cs.MAIN_SHAPES:
        x = torch.randn((nb, cs.RANK, m), generator=gen, device="cuda")
        x /= torch.linalg.norm(x, dim=(-2, -1), keepdim=True)
        g = ns.ns_gram_plain(x)
        p = b * g + c * torch.matmul(g, g)
        cases.append((x, p, per_step * cs.NS_STEPS, ns.ns_apply_plain(x, p, a)))
    builds = {name: _compile(name, consts) for name, consts in VARIANTS.items()}
    first = None
    for name, build in builds.items():
        lib, ptxas = _load(*build)
        outs, per_call, step_ms = [], [], 0.0
        for x, p, launches, want in cases:
            y = torch.empty_like(x)

            def call():
                rc = lib.repro_ns_apply(x.data_ptr(), p.data_ptr(), y.data_ptr(),
                                        a, x.shape[0], x.shape[1], x.shape[2],
                                        torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            call()
            torch.cuda.synchronize()
            assert cs._rel(y, want) <= cs.NS_RTOL, name
            outs.append(y.clone())
            ms = cs._graph_ms(call, launches)
            per_call.append(ms)
            step_ms += launches * ms
        first = first or outs
        print(json.dumps({
            "variant": name, "ms_per_trion_step": step_ms,
            "per_call_ms": per_call,
            "same_bits_as_first": all(map(torch.equal, outs, first)),
            "ptxas": ptxas}), flush=True)
    print(cs._device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
