// Fused basis projection S = G @ Q plus the squared column norms of S,
// for Hopper, in three precisions. Replaces
// repro/kernels/dct_project.py::_kernel (fp32, and bf16 with cast=bfloat16)
// and ::_kernel_q8 (int8).
//
// fp32. Bound: fp32 FMA rate. The product is 2*m*n*n flops per layer
// against 4*(m*n + n*n + m*n + n) bytes, far above the card's fp32 balance,
// and the tolerance of the fp32 path is exact fp32
// (LOWP_ERROR_BOUNDS["fp32"] == 0), so no TF32 tensor-core path is allowed.
// Design: a tiled SIMT GEMM. Each CTA owns a 128x128 tile of S for one
// layer (batch index in blockIdx.z), streams 8-deep slices of G and Q
// through shared memory, and each of its 256 threads keeps an 8x8 register
// tile accumulated with fp32 FMA. A thread's 8 rows (and 8 columns) are two
// groups of 4, 64 apart, so the float4 reads from shared memory are free of
// bank conflicts; the G slice is stored transposed with a 4-float pad for
// the same reason.
//
// bf16 is the same kernel with each operand rounded to bf16 (nearest even)
// as its tile is loaded, then multiplied and added in fp32: a product of two
// bf16 values is exact in fp32, so the result differs from an fp32 product
// of the rounded operands only by the order of the sums.
//
// int8 takes G quantized per row (codes + scales sg (batch, m)) and Q per
// column (codes + scales sq (n)); the wrapper quantizes. Bound: bytes (the
// fp32 S written dominates; int8 operations are cheap at the tensor-core
// rate this simple kernel does not use). Design: the fp32 kernel's tiling
// with 32-byte k slices held as packed words (4 codes of consecutive k per
// 32-bit word), accumulated exactly in int32 by __dp4a; every partial sum is
// an integer below 127^2 * n < 2^31 (the wrapper checks n). The Q slice is
// packed along k by a 4x4 byte transpose (__byte_perm) of four row words.
// The epilogue is (float(acc) * sg[i]) * sq[j] in that order, as the TPU
// kernel's, so S equals the plain version bit for bit. A k that is not a
// multiple of 32 is padded with zero codes, which add 0.
//
// Norms (every precision): the TPU kernel keeps each column's norm resident
// across a sequential sweep over row blocks. Row blocks run in parallel
// here, so the epilogue writes each CTA's column sums of squares to a
// partial buffer (batch, row_blocks, n), and a second kernel sums it over
// the row blocks in a fixed order. No atomics: the top-r selection
// downstream flips on a 1-ulp difference, so the sum must not depend on
// scheduling. The int8 norms are those of the dequantized S.
//
// Ragged m and n are masked in the loads and stores.
#include <cstdint>

#include <cuda_runtime.h>

#include "lowp.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
dct_project_kernel(const float* __restrict__ g, const float* __restrict__ q,
                   float* __restrict__ s, float* __restrict__ partial, int m, int n) {
  __shared__ __align__(16) float As[BK][BM + kPad];  // G slice, transposed
  __shared__ __align__(16) float Bs[BK][BN];         // Q slice
  __shared__ float col_sq[kThreads / 16][BN];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* gb = g + static_cast<long long>(b) * m * n;
  float* sb = s + static_cast<long long>(b) * m * n;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int t = 0; t < (BM * BK) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] =
          (gr < m && gc < n) ? operand<kBf16>(gb[static_cast<long long>(gr) * n + gc]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < (BK * BN) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / BN, c = e % BN;
      const int qr = k0 + r, qc = col0 + c;
      Bs[r][c] =
          (qr < n && qc < n) ? operand<kBf16>(q[static_cast<long long>(qr) * n + qc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: store S, and this thread's column sums of squares over its rows
  // (rows past m hold exact zeros: their G loads were masked)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lc = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
    const int col = col0 + lc;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if (row < m && col < n) sb[static_cast<long long>(row) * n + col] = acc[i][j];
      sq = fmaf(acc[i][j], acc[i][j], sq);
    }
    col_sq[ty][lc] = sq;
  }
  __syncthreads();
  if (tid < BN && col0 + tid < n) {
    float total = 0.f;
    for (int t = 0; t < kThreads / 16; ++t) total = __fadd_rn(total, col_sq[t][tid]);
    partial[(static_cast<long long>(b) * gridDim.y + blockIdx.y) * n + col0 + tid] = total;
  }
}

// int8: G codes (batch, m, n) with row scales sg (batch, m), Q codes (n, n)
// with column scales sq (n); the tiling of the fp32 kernel over packed words
constexpr int KW = 8;  // packed words per k slice: 32 codes

__global__ void __launch_bounds__(kThreads)
dct_project_q8_kernel(const int8_t* __restrict__ g, const int8_t* __restrict__ q,
                      const float* __restrict__ sg, const float* __restrict__ sq,
                      float* __restrict__ s, float* __restrict__ partial, int m, int n) {
  __shared__ __align__(16) int As[KW][BM + kPad];  // G slice, transposed
  __shared__ __align__(16) int Bs[KW][BN];         // Q slice, packed along k
  __shared__ float col_sq[kThreads / 16][BN];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int8_t* gb = g + static_cast<long long>(b) * m * n;
  float* sb = s + static_cast<long long>(b) * m * n;
  const float* sgb = sg + static_cast<long long>(b) * m;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool vec = n % 4 == 0;

  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < n; k0 += 4 * KW) {
#pragma unroll
    for (int t = 0; t < (BM * KW) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / KW, w = e % KW;
      const int gr = row0 + r, gc = k0 + 4 * w;
      As[w][r] = gr < m ? q8::load4(gb + static_cast<long long>(gr) * n + gc, n - gc, vec) : 0;
    }
    {  // one (word row, 4 columns) block of the Q slice per thread
      const int w = tid / (BN / 4), c = tid % (BN / 4);
      const int kr = k0 + 4 * w, col = col0 + 4 * c;
      int rw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rw[i] = kr + i < n ? q8::load4(q + static_cast<long long>(kr + i) * n + col, n - col, vec)
                           : 0;
      *reinterpret_cast<int4*>(&Bs[w][4 * c]) = q8::transpose4(rw);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int4 a0 = *reinterpret_cast<const int4*>(&As[w][ty * 4]);
      const int4 a1 = *reinterpret_cast<const int4*>(&As[w][64 + ty * 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Bs[w][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Bs[w][64 + tx * 4]);
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: S = (float(acc) * sg[row]) * sq[col], and this thread's column
  // sums of squares of it (rows and columns past the edge hold exact zeros)
  float rs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    rs[i] = row < m ? sgb[row] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lc = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
    const int col = col0 + lc;
    const float cs = col < n ? sq[col] : 0.f;
    float sqsum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), rs[i]), cs);
      if (row < m && col < n) sb[static_cast<long long>(row) * n + col] = v;
      sqsum = fmaf(v, v, sqsum);
    }
    col_sq[ty][lc] = sqsum;
  }
  __syncthreads();
  if (tid < BN && col0 + tid < n) {
    float total = 0.f;
    for (int t = 0; t < kThreads / 16; ++t) total = __fadd_rn(total, col_sq[t][tid]);
    partial[(static_cast<long long>(b) * gridDim.y + blockIdx.y) * n + col0 + tid] = total;
  }
}

// norms[b, c] = sum over row blocks t, in order, of partial[b, t, c]
__global__ void sum_row_blocks_kernel(const float* __restrict__ partial,
                                      float* __restrict__ norms, int row_blocks, int n,
                                      long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / n;
  const int c = static_cast<int>(i % n);
  const float* p = partial + b * row_blocks * n + c;
  float acc = 0.f;
  for (int t = 0; t < row_blocks; ++t) acc = __fadd_rn(acc, p[static_cast<long long>(t) * n]);
  norms[i] = acc;
}

}  // namespace

// rows of G per CTA: the wrapper sizes the partial-norm buffer with it
extern "C" int repro_dct_project_block_rows() { return BM; }

namespace {

dim3 project_grid(int batch, int m, int n) {
  return dim3((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
}

// the second stage: partial (batch, row_blocks, n) -> norms (batch, n)
int sum_row_blocks(const float* partial, float* norms, int batch, int m, int n,
                   cudaStream_t st) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * n;
  const int threads = 256;
  sum_row_blocks_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                          st>>>(partial, norms, (m + BM - 1) / BM, n, total);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int project(const float* g, const float* q, float* s, float* partial, float* norms, int batch,
            int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dct_project_kernel<kBf16><<<project_grid(batch, m, n), kThreads, 0, st>>>(g, q, s, partial, m,
                                                                             n);
  return sum_row_blocks(partial, norms, batch, m, n, st);
}

}  // namespace

extern "C" int repro_dct_project(const float* g, const float* q, float* s, float* partial,
                                 float* norms, int batch, int m, int n, void* stream) {
  return project<false>(g, q, s, partial, norms, batch, m, n, stream);
}

extern "C" int repro_dct_project_bf16(const float* g, const float* q, float* s, float* partial,
                                      float* norms, int batch, int m, int n, void* stream) {
  return project<true>(g, q, s, partial, norms, batch, m, n, stream);
}

extern "C" int repro_dct_project_q8(const int8_t* g, const int8_t* q, const float* sg,
                                    const float* sq, float* s, float* partial, float* norms,
                                    int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dct_project_q8_kernel<<<project_grid(batch, m, n), kThreads, 0, st>>>(g, q, sg, sq, s,
                                                                          partial, m, n);
  return sum_row_blocks(partial, norms, batch, m, n, st);
}
