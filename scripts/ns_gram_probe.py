#!/usr/bin/env python3
"""Time ``ns_gram`` of one source tree on one CUDA card, held to its plain
version first; with ``--variants``, the Gram kernel of this checkout at
other splits of m and other tile constants.

    python3 scripts/ns_gram_probe.py [--tree DIR] [--label NAME] [--rates]
                                     [--variants]

``--tree`` names another checkout (for example a parent commit unpacked
with ``git archive`` into ``build/``) whose ``src/repro_torch`` is imported
in place of this one's; the shapes, inputs and timers are this checkout's
``chip_smoke.py`` helpers, and the wrapper is called through the public
signature both trees have. To compare two trees on one card, run them in
turns in one command (A, B, B, A): the kernels of each tree build into its
own ``build/``.

Per Trion step of llama-350m (35 launches: 20 at the wide factor (24, 128,
1024), 15 at (24, 128, 2816)): the wrapper and ``torch.bmm(x, x.mT)`` (full
fp32, no TF32), each as eager calls (CUDA events around 10 calls) and as
CUDA-graph replays of a step's launches of each shape, with TFLOP/s
counted two ways: the r (r + 1) m flops of A's distinct entries (the row's
bound) and the 2 r^2 m of the whole square.

``--rates`` first measures the card's FFMA rate (the kernel of
``scripts/dct_project_probe.py --rates``) and reports each TFLOP/s as a
share of it. ``--variants`` builds copies of this checkout's
``csrc/newton_schulz.cu`` with other ``gram`` constants (the k slice
``BK``, the ring's depth ``kStages``, the CTAs per SM the launch bounds
ask for ``kMinBlocks``) into
``build/ns_gram_probe/<variant>/`` and calls each through its C entry
point at several splits of m (8 to 32 ranges of a multiple of the k
slice, none empty, as ``kernels.newton_schulz.ns_gram_splits`` cuts
them), as graph replays; a variant of the tile constants must
give the source's bits at the same split (the same sums in the same order;
null where the source did not run that split). Then diagnostic builds with
a phase cut out, and a timeline of the CTAs by the card's global timer.

Prints one JSON line per measurement and a ``probe_summary`` line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ns_gram_probe"

# name -> the gram constants that differ from the source's
VARIANTS = {
    "source": {},
    "4 CTAs/SM": {"kMinBlocks": 4},
    "2 stages (the first build's ring)": {"kStages": 2},
    "BK 8, 6 stages": {"BK": 8, "kStages": 6},
}
# the ranges of m tried (ns_gram_splits takes 16 at these shapes): 384
# CTAs at 16, 264 (2 an SM) at 11, 528 (4 an SM) at 22, 768 at 32
SPLITS_TRIED = (8, 11, 16, 22, 32)
# diagnostics, their results not held to anything: the source with a phase
# cut out (text replaced)
DIAGNOSTICS = {
    "diagnostic: no FMAs (loads, barriers, partials' stores, the sum)": [
        ("    if (mine.rb < 0) continue;", "    continue;")],
    "diagnostic: no slices (launches, partials' stores, the sum)": [
        ("  const int slices = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;",
         "  const int slices = 0;")],
    "diagnostic: the partial sums' kernel alone (no sum kernel)": [
        ("  constexpr int kChunks = kWarpsOf<kRows> * kPartFloats / 4;\n"
         "  const bool vec_out", "  return 0;\n"
         "  constexpr int kChunks = kWarpsOf<kRows> * kPartFloats / 4;\n"
         "  const bool vec_out")],
}
# the split policies the diagnostics run at: 16 ranges, 4, and 1
DIAGNOSTIC_SPLITS = (16, 4, 1)
# a diagnostic build that stamps the card's global timer (ns) at the start
# of the partial sums' kernel, the end of its k loop and after its stores;
# thread 0 of each CTA writes them, and its SM's id, over the start of its
# workspace entry (r <= 128)
TIMELINE_EDITS = [
    ("// ---- gram ----",
     "__device__ __forceinline__ unsigned long long stamp() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n// ---- gram ----"),
    ("  const Tile tile(r, blockIdx.y);\n  const int warp",
     "  const unsigned long long t0 = stamp();\n"
     "  const Tile tile(r, blockIdx.y);\n  const int warp"),
    ("  if (mine.rb < 0) return;\n  float* pw",
     "  const unsigned long long t1 = stamp();\n"
     "  if (mine.rb < 0) return;\n  float* pw"),
    ("          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], "
     "acc[i][4 * h + 3]);\n  }\n}",
     "          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], "
     "acc[i][4 * h + 3]);\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    const unsigned long long t2 = stamp();\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    const unsigned long long ts[3] = {t0, t1, t2};\n"
     "    unsigned* words = reinterpret_cast<unsigned*>(pw);\n"
     "    for (int i = 0; i < 3; ++i) {\n"
     "      words[2 * i] = static_cast<unsigned>(ts[i]);\n"
     "      words[2 * i + 1] = static_cast<unsigned>(ts[i] >> 32);\n"
     "    }\n    words[6] = sm;\n  }\n}"),
]
# appended to every variant's source: the r = 128 kernel's resident CTAs
# per SM, by the occupancy API
OCCUPANCY_SOURCE = r"""
extern "C" int probe_occupancy(int* blocks_per_sm) {
  auto kernel = &gram::ns_gram_kernel<128, 4>;
  const size_t smem = sizeof(gram::Ring<128>);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, 160, smem));
}
"""


def _ffma_rate() -> float:
    """The card's FFMA rate in TFLOP/s, by dct_project_probe's kernel."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import dct_project_probe as dpp

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "rates.cu", OUT / "rates"
    src.write_text(dpp.RATES_SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True).stdout
    print(out.strip(), flush=True)
    line = next(s for s in out.splitlines() if "fp32 ffma" in s)
    return json.loads(line)["tflop_per_s"]


def _compile(name: str, consts: dict, edits=()) -> tuple[Path,
                                                        subprocess.Popen]:
    """Write the variant's source (``consts`` replacing ``constexpr int``
    lines of namespace gram, ``edits`` other text; the occupancy query
    appended) and start its nvcc."""
    text = (CSRC / "newton_schulz.cu").read_text()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    head, rest = text.split("namespace gram {", 1)
    for key, value in consts.items():
        old = next(line for line in rest.splitlines()
                   if line.startswith(f"constexpr int {key} = "))
        rest = rest.replace(old, f"constexpr int {key} = {value};", 1)
    d = OUT / "".join(ch if ch.isalnum() else "_" for ch in name)
    d.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    (d / "newton_schulz.cu").write_text(head + "namespace gram {" + rest
                                        + OCCUPANCY_SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return d, subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(d / "lib.so"),
         str(d / "newton_schulz.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(d: Path, proc: subprocess.Popen) -> tuple[ctypes.CDLL, list[str]]:
    """The variant's library and ptxas' report of its r = 128 Gram kernels
    (W = 4: 16-byte copies, W = 1: 4-byte)."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {d.name}:\n{log}")
    ptxas, width = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"ns_gram_kernelILi128ELi(\d+)E", line)
            width = found and found.group(1)
        elif width and ("spill" in line or "registers" in line):
            ptxas.append(f"W={width}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_ns_gram.argtypes = [P, P, P, I, I, I, I, I, P]
    lib.repro_ns_gram.restype = I
    lib.probe_occupancy.argtypes = [P]
    lib.probe_occupancy.restype = I
    return lib, ptxas


def _occupancy(lib) -> int:
    """Resident CTAs per SM of the r = 128 kernel."""
    blocks = ctypes.c_int(0)
    assert lib.probe_occupancy(ctypes.byref(blocks)) == 0
    return blocks.value


def _splits(m: int, splits: int, slice_: int) -> tuple[int, int]:
    """``splits`` ranges of a multiple of ``slice_`` covering m, none
    empty (as ``ns_gram_splits`` cuts them)."""
    width = -(-m // splits)
    width = -(-width // slice_) * slice_
    return -(-m // width), width


def _call(lib, x, out, ws, splits: int, width: int) -> None:
    import torch
    nb, r, m = x.shape
    rc = lib.repro_ns_gram(x.data_ptr(), out.data_ptr(), ws.data_ptr(), nb, r,
                           m, splits, width,
                           torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc


def variants(torch, cs, cases, ffma: float | None) -> None:
    """Every tile variant at every split tried, and the diagnostics, as
    graph replays per Trion step."""
    from repro_torch.kernels import newton_schulz as ns

    builds = {name: _compile(name, c) for name, c in VARIANTS.items()}
    builds.update({name: _compile(name, {}, edits)
                   for name, edits in DIAGNOSTICS.items()})
    source_bits = {}
    sym = sum(launches * f for _, launches, _, f in cases)
    for name, build in builds.items():
        lib, ptxas = _load(*build)
        diagnostic = name in DIAGNOSTICS
        slice_ = VARIANTS.get(name, {}).get("BK", ns.GRAM_SLICE)
        for target in DIAGNOSTIC_SPLITS if diagnostic else SPLITS_TRIED:
            step_ms, per_call, same, geometry = 0.0, [], True, []
            for x, launches, want, _ in cases:
                nb, r, m = x.shape
                splits, width = _splits(m, target, slice_)
                geometry.append([m, splits, width])
                out = torch.empty((nb, r, r), device=x.device)
                ws = torch.empty(ns.ns_gram_workspace_floats(nb, r, splits),
                                 device=x.device)

                def call():
                    _call(lib, x, out, ws, splits, width)
                call()
                torch.cuda.synchronize()
                key = (m, splits, width)
                if diagnostic:
                    same = None
                else:
                    assert cs._rel(out, want) <= cs.NS_RTOL, (name, target)
                    assert torch.equal(out, out.mT), (name, target)
                    if name == "source":
                        source_bits[key] = out.clone()
                    if key not in source_bits:
                        same = None
                    elif same is not None:
                        same = torch.equal(out, source_bits[key])
                ms = cs._graph_ms(call, launches)
                per_call.append(ms)
                step_ms += launches * ms
            print(json.dumps({
                "variant": name, "ctas_per_sm": _occupancy(lib),
                "splits_m_width": geometry, "ms_per_trion_step": step_ms,
                "per_call_ms": per_call,
                "symmetric_tflop_per_s": sym / step_ms / 1e9,
                **({"share_of_ffma_rate_full_square":
                    2 * sym * 128 / 129 / step_ms / 1e9 / ffma} if ffma else {}),
                "same_bits_as_source_at_this_split": same,
                "ptxas": ptxas}), flush=True)


def timeline(torch, cases) -> None:
    """One call of the timeline build per main-path shape, at the wrapper's
    split: the CTAs per SM, and per CTA its start after the first CTA's, its
    k loop and its stores (us; median and max over the CTAs, and the k
    loop's median by the CTAs on its SM); the span from the first start to
    the last store."""
    import numpy as np

    from repro_torch.kernels import newton_schulz as ns

    lib, _ = _load(*_compile("diagnostic timeline", {}, TIMELINE_EDITS))
    for x, _, _, _ in cases:
        nb, r, m = x.shape
        splits, width = ns.ns_gram_splits(nb, r, m)
        out = torch.empty((nb, r, r), device=x.device)
        ws = torch.empty(ns.ns_gram_workspace_floats(nb, r, splits),
                         device=x.device)
        for _ in range(3):   # the last of three calls
            _call(lib, x, out, ws, splits, width)
        torch.cuda.synchronize()
        entry = ws.numel() // (nb * splits)
        w = ws.view(nb * splits, entry)[:, :7].contiguous().view(torch.int32)
        w = w.cpu().numpy().astype(np.uint32).astype(np.uint64)
        t = (w[:, 0:6:2] | (w[:, 1:6:2] << np.uint64(32))).astype(np.int64)
        sm = w[:, 6].astype(np.int64)
        us = (t - t[:, 0].min()) / 1e3
        loop = us[:, 1] - us[:, 0]
        per_sm = np.bincount(sm, minlength=int(sm.max()) + 1)
        ctas_on_sm = per_sm[sm]
        parts = {"start": us[:, 0], "k_loop": loop,
                 "stores": us[:, 2] - us[:, 1]}
        print(json.dumps({
            "timeline_wide": [nb, r, m], "splits": splits,
            "span_us": float(us[:, 2].max()),
            "sms_by_ctas": {int(k): int((per_sm == k).sum())
                            for k in np.unique(per_sm)},
            "k_loop_median_us_by_ctas_on_sm": {
                int(k): float(np.median(loop[ctas_on_sm == k]))
                for k in np.unique(ctas_on_sm)},
            **{k: {"median_us": float(np.median(v)), "max_us": float(v.max())}
               for k, v in parts.items()}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rates", action="store_true",
                    help="first measure the card's FFMA rate")
    ap.add_argument("--variants", action="store_true",
                    help="then this checkout's Gram kernel at other splits "
                         "and tile constants")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("ns_gram_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import newton_schulz as ns

    assert Path(cuda_lib.__file__).resolve().is_relative_to(tree), \
        cuda_lib.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    label = args.label or str(tree)
    print(json.dumps({"probe": label, "card": cs._device_line()}), flush=True)
    ffma = _ffma_rate() if args.rates else None
    cuda_lib.library()
    print("\n".join(line for line in cuda_lib.build_log().splitlines()
                    if "ns_gram" in line or "registers" in line
                    or "spill" in line), flush=True)

    gen = torch.Generator(device=dev).manual_seed(7)
    keys = ("gram_eager_ms", "gram_graph_ms", "bmm_eager_ms", "bmm_graph_ms")
    step = dict.fromkeys(keys, 0.0)
    sym_flops = full_flops = nbytes = 0.0
    cases = []
    for (nb, m, _), per_step in cs.MAIN_SHAPES:
        r, launches = cs.RANK, per_step * cs.NS_STEPS
        x = torch.randn((nb, r, m), generator=gen, device=dev)
        x /= torch.linalg.norm(x, dim=(-2, -1), keepdim=True)
        g, want = ns.ns_gram(x), ns.ns_gram_plain(x)
        torch.cuda.synchronize()
        err = cs._rel(g, want)
        assert err <= cs.NS_RTOL, (m, err)
        assert torch.equal(g, ns.ns_gram(x)) and torch.equal(g, g.mT), m
        flops = 1.0 * nb * r * (r + 1) * m
        cases.append((x, launches, want, flops))
        row = {"gram_eager_ms": cs._time_ms(lambda: ns.ns_gram(x)),
               "gram_graph_ms": cs._graph_ms(lambda: ns.ns_gram(x), launches),
               "bmm_eager_ms": cs._time_ms(lambda: torch.bmm(x, x.mT)),
               "bmm_graph_ms": cs._graph_ms(lambda: torch.bmm(x, x.mT),
                                            launches)}
        tflops = {k: flops / row[k] / 1e9 for k in keys}
        print(json.dumps({
            "ns_gram_wide": [nb, r, m], "per_call": row, "rel_err": err,
            "launches_per_step": launches,
            "symmetric_tflop_per_s": tflops,
            "full_square_tflop_per_s": {k: 2 * v * r / (r + 1)
                                        for k, v in tflops.items()}}),
              flush=True)
        for k in keys:
            step[k] += launches * row[k]
        sym_flops += launches * flops
        full_flops += launches * 2.0 * nb * r * r * m
        nbytes += launches * 4.0 * nb * (r * m + r * r)
    bound = cs._bound_ms(nbytes, sym_flops)
    summary = {"probe_summary": label, "ms_per_trion_step": step,
               "bound_ms": bound[0], "bound_by": bound[1],
               "symmetric_tflop_per_s": {k: sym_flops / v / 1e9
                                         for k, v in step.items()},
               "full_square_tflop_per_s": {k: full_flops / v / 1e9
                                           for k, v in step.items()}}
    if ffma:
        summary["ffma_tflop_per_s"] = ffma
        summary["full_square_share_of_ffma_rate"] = {
            k: full_flops / v / 1e9 / ffma for k, v in step.items()}
    print(json.dumps(summary), flush=True)
    if args.variants:
        variants(torch, cs, cases, ffma)
        timeline(torch, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
