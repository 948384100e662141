#!/usr/bin/env python3
"""The rate of ``mma.sync`` alone on one CUDA card: TF32 m16n8k8 and bf16
m16n8k16 with fp32 accumulators, by warps per SM and by independent
accumulator chains per warp (ILP).

    python3 scripts/tf32_mma_probe.py

Builds a small benchmark with ``nvcc`` (sm_90a) into
``build/tf32_mma_probe/`` and prints one JSON line per configuration:
TFLOP/s and mma per clock per SM at a nominal 1.755 GHz, then the card's
name and power limit. The operands are fixed fp32 bit patterns of
moderate values, so the rate is the instruction's and not the memory's:
it is the ceiling of a kernel built from these instructions (the fp32
``flash_attention``'s 3xTF32 passes, the bf16 prefill's products).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tf32_mma_probe"

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
template <bool kTf32, int ILP>
__global__ void bench(float* out, int iters) {
  float d[ILP][4] = {};
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(0.25f + 0.01f * ((threadIdx.x + i) % 17));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f - 0.01f * ((threadIdx.x + i) % 13));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < ILP; ++n) {
      if (kTf32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int n = 0; n < ILP; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool kTf32, int ILP>
void run(float* out, int sms, int warps_per_sm) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 16384 / ILP, blocks = sms * warps_per_sm / 4;
  bench<kTf32, ILP><<<blocks, 128>>>(out, 16);
  cudaEventRecord(e0);
  bench<kTf32, ILP><<<blocks, 128>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = double(blocks) * 4 * iters * ILP;
  const double flops = mmas * 16 * 8 * (kTf32 ? 8 : 16) * 2;
  printf("{\"mma\": \"%s\", \"warps_per_sm\": %d, \"ilp\": %d, \"tflop_per_s\": %.1f, "
         "\"mma_per_clk_per_sm_at_1755mhz\": %.3f}\n",
         kTf32 ? "tf32 m16n8k8" : "bf16 m16n8k16", warps_per_sm, ILP, flops / ms / 1e9,
         mmas / (ms * 1e-3) / sms / 1.755e9);
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 16 * 128);
  for (int w : {4, 8, 16}) {
    run<true, 1>(out, sms, w);
    run<true, 2>(out, sms, w);
    run<true, 8>(out, sms, w);
  }
  run<false, 8>(out, sms, 8);
  run<false, 8>(out, sms, 16);
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("tf32_mma_probe: no nvcc", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "mma_rate.cu", OUT / "mma_rate"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
    subprocess.run([str(exe)], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
