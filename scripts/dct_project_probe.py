#!/usr/bin/env python3
"""Time the fp32 and int8 ``dct_project`` of one source tree on one CUDA
card, each held to its plain version first.

    python3 scripts/dct_project_probe.py [--tree DIR] [--label NAME] [--rates]

``--tree`` names another checkout (for example a parent commit unpacked
with ``git archive`` into ``build/``) whose ``src/repro_torch`` is imported
in place of this one's; the shapes, inputs and timers are this checkout's
``chip_smoke.py`` helpers, and the wrappers are called through the public
signatures both trees have (the int8 kernel alone through
``dct_project_q8t`` where the tree has it, else ``dct_project_q8``). To
compare two trees on one card, run them in turns in one command (A, B, B,
A): the kernels of each tree build into its own ``build/``.

Per DCT-AdamW step of llama-350m (``chip_smoke.MAIN_SHAPES``: 4 launches
at G (24, 1024, 1024), 3 at (24, 2816, 1024)), with CUDA events:

* fp32: the kernel, ``torch.matmul(g, q)`` (full fp32, no TF32) and the
  bound (operations at the fp32 peak);
* int8: the kernel alone on quantized operands, the function with its
  operand quantization (``dct_project(..., compute_dtype="int8")``),
  ``torch._int_mm`` on the codes, and the device kernels one call of the
  function launches (``torch.profiler``).

``--rates`` first builds a small benchmark with ``nvcc`` into
``build/dct_project_probe/`` and prints the card's own rate of fp32 FFMA
and of int8 ``mma.sync.m16n8k32``, with the SM clock ``nvidia-smi`` reads
while they run: the ceilings of the two kernels at this card's clock.

Prints one JSON line per measurement and a ``probe_summary`` line.
"""
from __future__ import annotations

import argparse
import importlib
import json
import shutil
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "dct_project_probe"

RATES_SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
// ILP independent FFMA chains per thread
template <int ILP>
__global__ void ffma(float* out, int iters) {
  float x[ILP];
  for (int i = 0; i < ILP; ++i) x[i] = threadIdx.x * 1e-3f + i;
  const float a = 0.999f, b = 1e-4f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < ILP; ++i) x[i] = fmaf(x[i], a, b);
  float s = 0.f;
  for (int i = 0; i < ILP; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ILP independent int8 m16n8k32 accumulator chains per warp
template <int ILP>
__global__ void mma_s8(int* out, int iters) {
  int d[ILP][4] = {};
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x01010101u * ((threadIdx.x + i) % 3);
  for (int i = 0; i < 2; ++i) b[i] = 0x01010101u * ((threadIdx.x + i) % 2);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < ILP; ++n)
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+r"(d[n][0]), "+r"(d[n][1]), "+r"(d[n][2]), "+r"(d[n][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  int s = 0;
  for (int n = 0; n < ILP; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <typename F>
float time_ms(F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch(16);
  cudaEventRecord(e0);
  launch(0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  void* out;
  cudaMalloc(&out, sizeof(float) * sms * 8 * 1024);
  for (int rep = 0; rep < 3; ++rep) {
    const int iters = 1 << 16, blocks = sms * 8;
    const float ms = time_ms([&](int it) {
      ffma<8><<<blocks, 256>>>(static_cast<float*>(out), it ? it : iters);
    });
    printf("{\"rate\": \"fp32 ffma\", \"tflop_per_s\": %.2f}\n",
           2.0 * blocks * 256 * iters * 8 / ms / 1e9);
    for (int w : {8, 16}) {
      const int mi = 1 << 14, mb = sms * w / 4;
      const float mms = time_ms([&](int it) {
        mma_s8<8><<<mb, 128>>>(static_cast<int*>(out), it ? it : mi);
      });
      printf("{\"rate\": \"int8 mma.sync m16n8k32\", \"warps_per_sm\": %d, "
             "\"tops\": %.1f}\n", w, double(mb) * 4 * mi * 8 * 16 * 8 * 32 * 2 / mms / 1e9);
    }
  }
  return cudaGetLastError() != cudaSuccess;
}
"""


def _rates() -> None:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "rates.cu", OUT / "rates"
    src.write_text(RATES_SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
    clocks: list[str] = []
    done = threading.Event()

    def sample():
        while not done.is_set():
            clocks.append(_card_clock())
            done.wait(0.05)
    t = threading.Thread(target=sample)
    t.start()
    try:
        subprocess.run([str(exe)], check=True)
    finally:
        done.set()
        t.join()
    print(json.dumps({"sm_clock_mhz_while_running": sorted(set(clocks))}),
          flush=True)


def _card_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rates", action="store_true",
                    help="first measure the card's FFMA and int8 mma rates")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("dct_project_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dct import dct2_matrix
    from repro_torch.kernels import cuda_lib, lowp
    dp = importlib.import_module("repro_torch.kernels.dct_project")

    assert Path(cuda_lib.__file__).resolve().is_relative_to(tree), \
        cuda_lib.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    label = args.label or str(tree)
    print(json.dumps({"probe": label, "card": cs._device_line()}), flush=True)
    if args.rates:
        _rates()
    cuda_lib.library()
    print("\n".join(line for line in cuda_lib.build_log().splitlines()
                    if "registers" in line or "Compiling entry" in line
                    or "spill" in line), flush=True)

    gen = torch.Generator(device=dev).manual_seed(5)
    keys = ("fp32_ms", "fp32_matmul_ms", "fp32_bound_ms", "int8_kernel_ms",
            "int8_function_ms", "int8_int_mm_ms", "int8_kernel_bound_ms")
    step = dict.fromkeys(keys, 0.0)
    launches = {}
    for shape, per_step in cs.MAIN_SHAPES:
        nb, m, n = shape
        e = nb * m * n
        q = dct2_matrix(n, device=dev)
        g = cs._planted(shape, q, gen)
        s_k, n_k = dp.dct_project(g, q)
        s_p, n_p = dp.dct_project_plain(g, q)
        err = (s_k - s_p).abs().max().item()
        assert err <= 1e-5 * s_p.abs().max().item(), (shape, err)
        del s_k, n_k, s_p, n_p
        gq, sg = lowp.quant_rows(g)
        qq, sq = lowp.quant_cols(q)
        if hasattr(dp, "dct_project_q8t"):
            qtq = qq.T.contiguous()
            kernel = lambda: dp.dct_project_q8t(gq, sg, qtq, sq)  # noqa: E731
        else:
            kernel = lambda: dp.dct_project_q8(gq, sg, qq, sq)  # noqa: E731
        function = lambda: dp.dct_project(  # noqa: E731
            g, q, compute_dtype="int8")
        assert torch.equal(kernel()[0], dp.dct_project_q8_plain(
            gq, sg, qq, sq)[0]), shape
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            function()
            torch.cuda.synchronize()
        kernels, _ = cs._device_kernels(prof)
        launches[str(shape)] = {
            "device_kernels_per_int8_call": sum(k.count for k in kernels),
            "names": sorted(k.key[:60] for k in kernels)}
        row = {
            "fp32_ms": cs._time_ms(lambda: dp.dct_project(g, q)),
            "fp32_matmul_ms": cs._time_ms(lambda: torch.matmul(g, q)),
            "fp32_bound_ms": cs._bound_ms(
                4.0 * (2 * e + n * n + nb * n), 2.0 * e * n + 2.0 * e)[0],
            "int8_kernel_ms": cs._time_ms(kernel),
            "int8_function_ms": cs._time_ms(function),
            "int8_int_mm_ms": cs._library_ms(
                lambda: torch._int_mm(gq.view(-1, n), qq)) or float("nan"),
            "int8_kernel_bound_ms": cs._bound_ms(
                1.0 * (e + n * n) + 4.0 * (nb * m + n) + 4.0 * (e + nb * n),
                2.0 * e * n, cs.PEAK_INT8_PER_S)[0]}
        print(json.dumps({"shape": list(shape), "per_call": row,
                          "fp32_max_abs_err": err,
                          "fp32_tflop_per_s": 2.0 * e * n / row["fp32_ms"]
                          / 1e9, **launches[str(shape)]}), flush=True)
        for k in keys:
            step[k] += per_step * row[k]
        del g, gq, qq, kernel, function
        torch.cuda.empty_cache()
    print(json.dumps({"probe_summary": label, "card": cs._device_line(),
                      "per_dct_adamw_step_ms": step,
                      "fp32_vs_matmul": step["fp32_ms"]
                      / step["fp32_matmul_ms"],
                      "int8_kernel_vs_int_mm": step["int8_kernel_ms"]
                      / step["int8_int_mm_ms"],
                      "device_kernels_per_int8_call": {
                          k: v["device_kernels_per_int8_call"]
                          for k, v in launches.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
