// Newton-Schulz iteration kernels for Hopper. One NS5 step on a wide factor
// X (batch, r, m), r <= m, is
//   A = X X^T          ns_gram_kernel    replaces repro/kernels/newton_schulz.py::_gram_kernel
//   P = b A + c A A    (r, r): a batched torch.matmul in the wrapper, as the
//                      JAX package computes it outside Pallas
//   Y = a X + P X      ns_apply_kernel   replaces repro/kernels/newton_schulz.py::_apply_kernel
//
// Bound: the fp32 FMA rate. Each kernel does 2 r^2 m flops per layer against
// 4 r m bytes read (gram) or 8 r m bytes read and written (apply): at Trion's
// r = 128 that is 64 and 32 flops per byte, above the card's fp32 balance of
// 20 (67 TFLOP/s over 3.35 TB/s). No TF32: the iteration's slope at 0 is
// a = 3.4445, so a relative error in a small singular direction grows up to
// a^steps times over the iteration.
//
// ns_gram: the TPU kernel sweeps X's column blocks as a sequential grid axis
// with the (r, r) sum resident in VMEM. CTAs run in parallel and in no order
// here, so each CTA owns one 32x32 tile of A for one layer and itself loops
// over all m columns, 32 at a time, in a fixed order: no split across CTAs,
// no atomics, the same bits on every launch. Inside the CTA four groups of 64
// threads take the four 8-column slices of every chunk (each thread a 4x4
// register tile), and the four partial tiles are added in a fixed order at
// the end. Only the tiles on or above the diagonal are computed (10 of 16 at
// r = 128); each off-diagonal one is written with its transpose, so A is
// exactly symmetric (inside a diagonal tile A[p][q] and A[q][p] come from
// the same FMAs: fmaf(x_p, x_q, s) == fmaf(x_q, x_p, s)). Columns past m
// and rows past r load as zeros, which add nothing to A (the TPU kernel pads
// the columns with zeros too).
//
// ns_apply: a tiled SIMT GEMM with K = r: 64x128 output tiles, 256 threads
// with 4x8 register tiles (the layout of colgather_matmul.cu), and the a*X
// term added in the epilogue as a multiply and then an add, the rounding of
// the plain version. It writes a buffer other than its input: a CTA owns 64
// rows of its column block, and the CTAs of the other rows still read X
// there. The wrapper ping-pongs two buffers across the iterations.
//
// Both kernels load the next chunk of their operands into registers while
// the current one is computed from shared memory, so the loads' latency
// overlaps the FMAs; the FMA order, and so every bit, is that of loading
// and computing in turn.
//
// Shared memory is 26 KB (gram) and 6.5 KB (apply) whatever r is: the
// kernels have no envelope on r of their own (see fused_step.py).
#include <cuda_runtime.h>

namespace {

// ---- gram -----------------------------------------------------------------
constexpr int GT = 32;            // A tile
constexpr int GK = 32;            // columns of X per chunk
constexpr int kGroups = 4;        // column slices of a chunk, one per group
constexpr int kGramThreads = 256;
constexpr int kGPad = 4;          // keeps float4 rows aligned

// at least 3 CTAs per SM: Trion's 24 x 10 = 240 tiles run in one wave
__global__ void __launch_bounds__(kGramThreads, 3)
ns_gram_kernel(const float* __restrict__ x, float* __restrict__ gram, int r, int m) {
  __shared__ __align__(16) float Xi[GK][GT + kGPad];   // rows i0.., transposed
  __shared__ __align__(16) float Xj[GK][GT + kGPad];   // rows j0.., transposed
  __shared__ float part[kGroups][GT][GT + 1];

  // blockIdx.x counts the tiles (ti, tj), ti <= tj, row by row
  const int tiles = (r + GT - 1) / GT;
  int ti = 0, rest = blockIdx.x;
  while (rest >= tiles - ti) {
    rest -= tiles - ti;
    ++ti;
  }
  const int b = blockIdx.z;
  const int i0 = ti * GT;
  const int j0 = (ti + rest) * GT;
  const float* xb = x + static_cast<long long>(b) * r * m;
  const int tid = threadIdx.x;
  const int grp = tid / 64;
  const int t = tid % 64;
  const int tx = t % 8;           // columns j0 + tx*4 .. +4 of the tile
  const int ty = t / 8;           // rows    i0 + ty*4 .. +4

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the next chunk is loaded into registers while this one is computed
  constexpr int kLoads = (GT * GK) / kGramThreads;
  float ni[kLoads], nj[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kGramThreads;
      const int rr = e / GK, c = e % GK;       // a warp reads 32 columns of a row
      const int col = k0 + c;
      const bool okc = col < m;
      const int ri = i0 + rr, rj = j0 + rr;
      ni[u] = (okc && ri < r) ? xb[static_cast<long long>(ri) * m + col] : 0.f;
      nj[u] = (okc && rj < r) ? xb[static_cast<long long>(rj) * m + col] : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < m; k0 += GK) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kGramThreads;
      Xi[e % GK][e / GK] = ni[u];
      Xj[e % GK][e / GK] = nj[u];
    }
    __syncthreads();
    if (k0 + GK < m) load(k0 + GK);
#pragma unroll
    for (int kk = 0; kk < GK / kGroups; ++kk) {
      const int k = grp * (GK / kGroups) + kk;
      const float4 a4 = *reinterpret_cast<const float4*>(&Xi[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Xj[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[grp][ty * 4 + i][tx * 4 + j] = acc[i][j];
  __syncthreads();
  float* gb = gram + static_cast<long long>(b) * r * r;
#pragma unroll
  for (int u = 0; u < (GT * GT) / kGramThreads; ++u) {
    const int e = tid + u * kGramThreads;
    const int p = e / GT, q = e % GT;
    float s = part[0][p][q];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) s = __fadd_rn(s, part[g][p][q]);
    if (i0 + p < r && j0 + q < r) {
      gb[static_cast<long long>(i0 + p) * r + j0 + q] = s;
      if (i0 != j0) gb[static_cast<long long>(j0 + q) * r + i0 + p] = s;
    }
  }
}

// ---- apply ----------------------------------------------------------------
constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int kApplyThreads = 256;
constexpr int kPad = 4;

__global__ void __launch_bounds__(kApplyThreads)
ns_apply_kernel(const float* __restrict__ x, const float* __restrict__ p,
                float* __restrict__ y, float a, int r, int m) {
  __shared__ __align__(16) float As[BK][BM + kPad];  // P slice, transposed
  __shared__ __align__(16) float Bs[BK][BN];         // X slice

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* xb = x + static_cast<long long>(b) * r * m;
  const float* pb = p + static_cast<long long>(b) * r * r;
  float* yb = y + static_cast<long long>(b) * r * m;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the next slices are loaded into registers while this one is computed
  constexpr int kLoadsA = (BM * BK) / kApplyThreads;
  constexpr int kLoadsB = (BK * BN) / kApplyThreads;
  float na[kLoadsA], nx[kLoadsB];
  auto load = [&](int k0) {
#pragma unroll
    for (int t = 0; t < kLoadsA; ++t) {
      const int e = tid + t * kApplyThreads;
      const int gr = row0 + e / BK, gc = k0 + e % BK;
      na[t] = (gr < r && gc < r) ? pb[static_cast<long long>(gr) * r + gc] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kLoadsB; ++t) {
      const int e = tid + t * kApplyThreads;
      const int k = k0 + e / BN, col = col0 + e % BN;
      nx[t] = (k < r && col < m) ? xb[static_cast<long long>(k) * m + col] : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < r; k0 += BK) {
#pragma unroll
    for (int t = 0; t < kLoadsA; ++t) {
      const int e = tid + t * kApplyThreads;
      As[e % BK][e / BK] = na[t];
    }
#pragma unroll
    for (int t = 0; t < kLoadsB; ++t) {
      const int e = tid + t * kApplyThreads;
      Bs[e / BN][e % BN] = nx[t];
    }
    __syncthreads();
    if (k0 + BK < r) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 x0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= r) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < m) {
        const long long off = static_cast<long long>(row) * m + col;
        yb[off] = __fadd_rn(__fmul_rn(a, xb[off]), acc[i][j]);
      }
    }
  }
}

}  // namespace

extern "C" int repro_ns_gram(const float* x, float* gram, int batch, int r, int m,
                             void* stream) {
  if (batch > 0 && r > 0) {
    const int tiles = (r + GT - 1) / GT;
    const dim3 grid(tiles * (tiles + 1) / 2, 1, batch);
    ns_gram_kernel<<<grid, kGramThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, gram, r,
                                                                                 m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_ns_apply(const float* x, const float* p, float* y, float a, int batch,
                              int r, int m, void* stream) {
  if (batch > 0 && r > 0 && m > 0) {
    const dim3 grid((m + BN - 1) / BN, (r + BM - 1) / BM, batch);
    ns_apply_kernel<<<grid, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, p, y, a,
                                                                                   r, m);
  }
  return static_cast<int>(cudaGetLastError());
}
