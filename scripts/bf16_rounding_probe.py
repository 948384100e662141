#!/usr/bin/env python3
"""Time the bf16 ``dct_project`` kernel under four ways of rounding an fp32
operand to bf16, against the fp32 kernel, on one CUDA card.

    python3 scripts/bf16_rounding_probe.py

Run from the root of a checkout. It copies the fp32/bf16 kernel of
``src/repro_torch/csrc/dct_project.cu`` into a variant whose operand
rounding is a template parameter, builds it with ``nvcc`` into
``build/bf16_rounding_probe/`` and times each mode with CUDA events at
llama-350m's two G shapes (24, 1024 | 2816, 1024), Q (1024, 1024):

  0  fp32 (no rounding)
  1  ``__float2bfloat16_rn`` (the kernel's rounding)
  2  round half to even on the bits, four integer operations, no NaN test
     (CUDA's canonical NaN 0x7FFFFFFF carries into the sign: -0.0)
  3  as 2, with an early return for NaN
  4  as 2, with the NaN test as a select

Modes 2-4 are checked equal to mode 1 on the (NaN-free) inputs, and mode 2
shown to turn 0x7FFFFFFF into -0.0. Prints one JSON line per shape.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "bf16_rounding_probe"

OPERAND = r'''
template <int kMode>
__device__ __forceinline__ float operand(float x) {
  if constexpr (kMode == 0) return x;
  if constexpr (kMode == 1) return __bfloat162float(__float2bfloat16_rn(x));
  unsigned u = __float_as_uint(x);
  if constexpr (kMode == 3) {
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) return x;
  }
  unsigned r = u + 0x7FFFu + ((u >> 16) & 1u);
  if constexpr (kMode == 4) r = ((u & 0x7FFFFFFFu) > 0x7F800000u) ? (u | 0x00400000u) : r;
  return __uint_as_float(r & 0xFFFF0000u);
}
'''

ENTRY = r'''
}  // namespace

extern "C" int probe_project(int mode, const float* g, const float* q, float* s,
                             float* partial, int batch, int m, int n, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: dct_project_kernel<0><<<grid, kThreads, 0, st>>>(g, q, s, partial, m, n); break;
    case 1: dct_project_kernel<1><<<grid, kThreads, 0, st>>>(g, q, s, partial, m, n); break;
    case 2: dct_project_kernel<2><<<grid, kThreads, 0, st>>>(g, q, s, partial, m, n); break;
    case 3: dct_project_kernel<3><<<grid, kThreads, 0, st>>>(g, q, s, partial, m, n); break;
    default: dct_project_kernel<4><<<grid, kThreads, 0, st>>>(g, q, s, partial, m, n); break;
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void round_one(const float* x, float* y) { y[0] = operand<2>(x[0]); }

extern "C" int probe_round_mode2(const float* x, float* y, void* stream) {
  round_one<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(x, y);
  return static_cast<int>(cudaGetLastError());
}
'''


def _source() -> str:
    src = (ROOT / "src/repro_torch/csrc/dct_project.cu").read_text()
    body = src[src.index("namespace {"):src.index("// int8: G codes")]
    body = body.replace("template <bool kBf16>\n__global__",
                        "template <int kBf16>\n__global__")
    head = "#include <cstdint>\n#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n"
    i = body.index("\n", body.index("namespace {"))
    return head + body[:i + 1] + OPERAND + body[i + 1:] + ENTRY


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bf16_rounding_probe: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probe.cu").write_text(_source())
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(OUT / "probe.so"),
                    str(OUT / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(OUT / "probe.so"))
    lib.probe_project.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.probe_round_mode2.argtypes = [ctypes.c_void_p] * 3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    st = torch.cuda.current_stream().cuda_stream
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32, device=dev).view(torch.float32)
    y = torch.empty(1, device=dev)
    assert lib.probe_round_mode2(nan.data_ptr(), y.data_ptr(), st) == 0
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(0)
    for nb, m, n in ((24, 1024, 1024), (24, 2816, 1024)):
        g = torch.randn(nb, m, n, generator=gen, device=dev)
        q = torch.randn(n, n, generator=gen, device=dev)
        s = torch.empty_like(g)
        partial = torch.empty(nb, -(-m // 128), n, device=dev)
        ms, outs = {}, {}
        for mode in (0, 1, 2, 3, 4, 0, 1, 2, 3, 4):
            def run():
                assert lib.probe_project(mode, g.data_ptr(), q.data_ptr(), s.data_ptr(),
                                         partial.data_ptr(), nb, m, n, st) == 0
            run()
            torch.cuda.synchronize()
            outs[mode] = s.clone()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(10):
                run()
            b.record()
            torch.cuda.synchronize()
            ms.setdefault(mode, []).append(a.elapsed_time(b) / 10)
        print(json.dumps({
            "shape": [nb, m, n], "ms_per_call": ms,
            "equal_to_mode_1": {k: torch.equal(outs[1], outs[k]) for k in (2, 3, 4)},
            "mode_2_of_nan_0x7fffffff": y.item()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
