// Fused basis projection S = G @ Q plus the squared column norms of S,
// for Hopper. Replaces repro/kernels/dct_project.py::_kernel (fp32 path).
//
// Bound: fp32 FMA rate. The product is 2*m*n*n flops per layer against
// 4*(m*n + n*n + m*n + n) bytes, far above the card's fp32 balance, and the
// tolerance of the fp32 path is exact fp32 (LOWP_ERROR_BOUNDS["fp32"] == 0),
// so no TF32 tensor-core path is allowed. Design: a tiled SIMT GEMM. Each
// CTA owns a 128x128 tile of S for one layer (batch index in blockIdx.z),
// streams 8-deep slices of G and Q through shared memory, and each of its
// 256 threads keeps an 8x8 register tile accumulated with fp32 FMA. A
// thread's 8 rows (and 8 columns) are two groups of 4, 64 apart, so the
// float4 reads from shared memory are free of bank conflicts; the G slice is
// stored transposed with a 4-float pad for the same reason.
//
// Norms: the TPU kernel keeps each column's norm resident across a
// sequential sweep over row blocks. Row blocks run in parallel here, so the
// epilogue writes each CTA's column sums of squares to a partial buffer
// (batch, row_blocks, n), and a second kernel sums it over the row blocks
// in a fixed order. No atomics: the top-r selection downstream flips on a
// 1-ulp difference, so the sum must not depend on scheduling.
//
// Ragged m and n are masked in the loads and stores; nothing is padded.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;

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
      As[c][r] = (gr < m && gc < n) ? gb[static_cast<long long>(gr) * n + gc] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < (BK * BN) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / BN, c = e % BN;
      const int qr = k0 + r, qc = col0 + c;
      Bs[r][c] = (qr < n && qc < n) ? q[static_cast<long long>(qr) * n + qc] : 0.f;
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

extern "C" int repro_dct_project(const float* g, const float* q, float* s, float* partial,
                                 float* norms, int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_blocks = (m + BM - 1) / BM;
  const dim3 grid((n + BN - 1) / BN, row_blocks, batch);
  dct_project_kernel<<<grid, kThreads, 0, st>>>(g, q, s, partial, m, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * n;
  const int threads = 256;
  sum_row_blocks_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                          st>>>(partial, norms, row_blocks, n, total);
  return static_cast<int>(cudaGetLastError());
}
