// int8 quantizers and the error-feedback kernels of DCT-AdamW (paper §2.4)
// for Hopper.
//
// quantize_ef replaces repro/kernels/quant_ef.py::_quant_kernel and
// dequant_add_ef replaces ::_dequant_add_kernel. Both are bound by bytes:
// quantize reads 4 B and writes 1 B per element (plus 4 B per row),
// dequant-add reads 4 + 1 B and writes 4 B per element. One CTA per row
// keeps the row scale in a register for the whole row, so the per-row amax
// needs no second kernel and the dequant-add needs no division to find its
// row. Leading stacked axes are collapsed into the row count by the caller.
//
// The int8 dct_project's operands are quantized here too, one launch each
// (the JAX package's repro/kernels/lowp.py quant_rows / quant_cols, which
// XLA fuses into its jitted step): G per row by the same kernel as the EF
// buffer (entry point repro_quant_rows_q8, its own launch count), and Q per
// column by quant_cols_q8t, which writes Q^T's codes (row j = column j of
// Q), the layout dct_project.cu's int8 kernel reads. A CTA owns 32 columns:
// it reads them once for the column amax, then again (from L2) in chunks
// of rows that it quantizes and transposes through shared memory, so the
// codes are written along rows of Q^T. Bound: bytes; Q is small (n x n),
// so it is a few microseconds a launch.
//
// The int8 colgather's operands (the JAX package's
// repro/kernels/colgather_matmul.py:158-162, jnp ops that XLA fuses into
// its jitted step) are quantized here too, two launches per call: Q^T per
// row by the same kernel again (entry point repro_quant_qt_q8, its own
// launch count), and both b operands of a dual call (or the one of a
// single call) by quant_fold_q8: each row of b times the scales of the
// selected rows of Q^T (column k takes s_qt[idx[k]]; an index outside
// [0, n) reads as a zero row, whose scale is F32_TINY), then quantized per
// row. The rows are r long (the rank, ~128), so a warp owns a row and a
// CTA eight of them; it reads the row twice (the amax, then the codes),
// computing the same products both times. Bound: bytes.
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

// x (rows, cols) row-major -> per-column scales (cols) and the codes of x^T
// (cols, rows): qt[j * rows + i] = code of x[i, j]. A CTA of 32 x 32
// threads owns 32 columns: thread (tx, ty) reads column tx at rows ty,
// ty + 32, ... (128 contiguous bytes per warp), first for the amax, then in
// chunks of kChunk rows whose codes go through shared memory, so the
// stores run along rows of x^T.
constexpr int kChunk = 256;

__global__ void __launch_bounds__(1024)
quant_cols_q8t_kernel(const float* __restrict__ x, int8_t* __restrict__ qt,
                      float* __restrict__ scale, int rows, int cols) {
  __shared__ float part[32][33];
  __shared__ float col_scale[32];
  __shared__ int8_t tile[32][kChunk + 4];  // [column][row of the chunk]
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int j0 = blockIdx.x * 32, j = j0 + tx;

  float amax = 0.f;
  if (j < cols) {
#pragma unroll 8
    for (int i = ty; i < rows; i += 32)
      amax = fmaxf(amax, fabsf(x[static_cast<long long>(i) * cols + j]));
  }
  part[ty][tx] = amax;
  __syncthreads();
  if (ty == 0) {
    float m = part[0][tx];
    for (int w = 1; w < 32; ++w) m = fmaxf(m, part[w][tx]);
    // the same scale as quantize_ef_kernel's rows
    const float s = fmaxf(__fdiv_rn(m, 127.f), FLT_MIN);
    col_scale[tx] = s;
    if (j < cols) scale[j] = s;
  }
  __syncthreads();

  const float s = col_scale[tx];
  for (int i0 = 0; i0 < rows; i0 += kChunk) {
#pragma unroll
    for (int r = ty; r < kChunk; r += 32) {
      const int i = i0 + r;
      int8_t code = 0;
      if (i < rows && j < cols) {
        const float v = rintf(__fdiv_rn(x[static_cast<long long>(i) * cols + j], s));
        code = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
      }
      tile[tx][r] = code;
    }
    __syncthreads();
    for (int e = tid; e < 32 * kChunk; e += 1024) {
      const int c = e / kChunk, r = e % kChunk;
      if (j0 + c < cols && i0 + r < rows)
        qt[static_cast<long long>(j0 + c) * rows + i0 + r] = tile[c][r];
    }
    __syncthreads();
  }
}

// rows (batch * m) of b1 (and b2), r long, idx (batch, r), s_qt (n): a
// warp per row of every operand
constexpr int kFoldWarps = 8;

template <int kOps>
__global__ void __launch_bounds__(kFoldWarps * 32)
quant_fold_q8_kernel(const float* __restrict__ b1, const float* __restrict__ b2,
                     const float* __restrict__ s_qt, const int* __restrict__ idx,
                     int8_t* __restrict__ q1, int8_t* __restrict__ q2, float* __restrict__ sc1,
                     float* __restrict__ sc2, long long rows, int m, int r, int n) {
  const long long row = static_cast<long long>(blockIdx.x) * kFoldWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int* idx_b = idx + (row / m) * r;
  const long long off = row * r;
  const float* x[2] = {b1 + off, kOps == 2 ? b2 + off : nullptr};
  // the selected row's scale; a zero row's (F32_TINY) for a bad index
  const auto sel = [&](int k) {
    const int j = idx_b[k];
    return j >= 0 && j < n ? s_qt[j] : FLT_MIN;
  };

  float amax[2] = {0.f, 0.f};
  for (int k = lane; k < r; k += 32) {
    const float s = sel(k);
#pragma unroll
    for (int op = 0; op < kOps; ++op) amax[op] = fmaxf(amax[op], fabsf(__fmul_rn(x[op][k], s)));
  }
  float scale[2];
#pragma unroll
  for (int op = 0; op < kOps; ++op) {
    for (int o = 16; o > 0; o >>= 1)
      amax[op] = fmaxf(amax[op], __shfl_xor_sync(0xffffffffu, amax[op], o));
    // quantize_ef_kernel's scale
    scale[op] = fmaxf(__fdiv_rn(amax[op], 127.f), FLT_MIN);
  }
  if (lane == 0) {
    sc1[row] = scale[0];
    if constexpr (kOps == 2) sc2[row] = scale[1];
  }
  int8_t* q[2] = {q1 + off, kOps == 2 ? q2 + off : nullptr};
  for (int k = lane; k < r; k += 32) {
    const float s = sel(k);
#pragma unroll
    for (int op = 0; op < kOps; ++op) {
      const float v = rintf(__fdiv_rn(__fmul_rn(x[op][k], s), scale[op]));
      q[op][k] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
    }
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

namespace {

int quantize_rows(const float* x, int8_t* q, float* scale, long long rows, int n,
                  void* stream) {
  if (rows > 0 && n > 0)
    quantize_ef_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, q, scale, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_quantize_ef(const float* x, int8_t* q, float* scale,
                                 long long rows, int n, void* stream) {
  return quantize_rows(x, q, scale, rows, n, stream);
}

// the int8 dct_project's G: the same kernel, launched for another caller
extern "C" int repro_quant_rows_q8(const float* x, int8_t* q, float* scale,
                                   long long rows, int n, void* stream) {
  return quantize_rows(x, q, scale, rows, n, stream);
}

// the int8 colgather's Q^T: the same kernel, launched for another caller
extern "C" int repro_quant_qt_q8(const float* x, int8_t* q, float* scale, long long rows, int n,
                                 void* stream) {
  return quantize_rows(x, q, scale, rows, n, stream);
}

// both b operands of the int8 colgather (b2 null: the one of a single call)
extern "C" int repro_quant_fold_q8(const float* b1, const float* b2, const float* s_qt,
                                   const int* idx, int8_t* q1, int8_t* q2, float* sc1,
                                   float* sc2, long long rows, int m, int r, int n,
                                   void* stream) {
  if (rows > 0 && r > 0) {
    const unsigned grid = static_cast<unsigned>((rows + kFoldWarps - 1) / kFoldWarps);
    const auto st = static_cast<cudaStream_t>(stream);
    if (b2)
      quant_fold_q8_kernel<2><<<grid, kFoldWarps * 32, 0, st>>>(b1, b2, s_qt, idx, q1, q2, sc1,
                                                                sc2, rows, m, r, n);
    else
      quant_fold_q8_kernel<1><<<grid, kFoldWarps * 32, 0, st>>>(b1, b2, s_qt, idx, q1, q2, sc1,
                                                                sc2, rows, m, r, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_quant_cols_q8t(const float* x, int8_t* qt, float* scale, int rows,
                                    int cols, void* stream) {
  if (rows > 0 && cols > 0)
    quant_cols_q8t_kernel<<<static_cast<unsigned>((cols + 31) / 32), dim3(32, 32), 0,
                            static_cast<cudaStream_t>(stream)>>>(x, qt, scale, rows, cols);
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
