// int8 error-feedback kernels of DCT-AdamW (paper §2.4) for Hopper.
//
// quantize_ef replaces repro/kernels/quant_ef.py::_quant_kernel and
// dequant_add_ef replaces ::_dequant_add_kernel. Both are bound by bytes:
// quantize reads 4 B and writes 1 B per element (plus 4 B per row),
// dequant-add reads 4 + 1 B and writes 4 B per element. One CTA per row
// keeps the row scale in a register for the whole row, so the per-row amax
// needs no second kernel and the dequant-add needs no division to find its
// row. Leading stacked axes are collapsed into the row count by the caller.
//
// Numerics follow the JAX reference exactly: IEEE division x / scale (not a
// multiply by 1/scale, which flips int8 ties), round half to even (rintf),
// the F32_TINY clamp on the scale, and no fused multiply-add in g + q*scale.
// Build without --use_fast_math: it would change both the division and the
// handling of subnormal rows.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_ef_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                   float* __restrict__ scale, int n) {
  const long long row = blockIdx.x;
  const float* xr = x + row * n;
  int8_t* qr = q + row * n;

  float amax = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) amax = fmaxf(amax, fabsf(xr[j]));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    // max(amax / 127, smallest normal): a subnormal row would otherwise
    // underflow the scale to 0 and x / 0 would poison the payload
    const float s = fmaxf(__fdiv_rn(m, 127.f), FLT_MIN);
    row_scale = s;
    scale[row] = s;
  }
  __syncthreads();

  const float s = row_scale;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float v = rintf(__fdiv_rn(xr[j], s));
    qr[j] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_add_ef_kernel(const float* __restrict__ g, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ out, int n) {
  const long long row = blockIdx.x;
  const long long base = row * n;
  const float s = scale[row];
  for (int j = threadIdx.x; j < n; j += kThreads)
    out[base + j] = __fadd_rn(g[base + j], __fmul_rn(static_cast<float>(q[base + j]), s));
}

}  // namespace

extern "C" int repro_quantize_ef(const float* x, int8_t* q, float* scale,
                                 long long rows, int n, void* stream) {
  if (rows > 0 && n > 0)
    quantize_ef_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, q, scale, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dequant_add_ef(const float* g, const int8_t* q, const float* scale,
                                    float* out, long long rows, int n, void* stream) {
  if (rows > 0 && n > 0)
    dequant_add_ef_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(g, q, scale, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
