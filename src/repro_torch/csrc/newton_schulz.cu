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
// ns_apply: a pipelined SIMT GEMM with K = r in which a CTA owns every row
// of Y for one stripe of 64 columns, so X is read from device memory once
// and Y written once (the bound's 8 r m bytes). The CTA's (r, 64) stripe of
// X arrives by cp.async (16-byte pieces; 4-byte ones where r % 4, m % 4 or
// an address forbids 16) into shared memory and stays there: it is the B
// operand of P X and the a X of the epilogue. P streams through a 2-stage
// cp.async ring of 16-deep k slices (r^2 fp32, 64 KB at r = 128, read by
// every CTA of its layer from L2); each thread transposes the pieces of P it
// copied itself into a double-buffered k-major tile, so one barrier per
// slice suffices (the design of dct_project.cu's fp32 kernel). 128 threads,
// each with an 8 x 8 register tile (rows in two groups of 4, 64 apart;
// columns in two groups of 4, 32 apart; a warp is 4 thread rows x 8 thread
// columns, so each float4 shared read covers 64 or 128 contiguous bytes: no
// bank conflicts), accumulated with IEEE fp32 FMA, k ascending; the a*X term
// is added in the epilogue as a multiply and then an add, the rounding of
// the plain version. The same bits on every launch. Rows come in blocks of
// 128: for r > 128 the CTA loops over them, streaming each block's rows of P
// against the resident stripe. The grid is (m / 64, layers): Trion's leaves
// give 384 CTAs at m = 1024 and 1056 at m = 2816, on 132 SMs that hold 3
// CTAs each at r = 128 (65 KB of shared memory, at most 170 registers a
// thread). It writes a buffer other than its input; the wrapper ping-pongs
// two buffers across the iterations.
//
// Envelope: the stripe takes 256 bytes per row of X (rows padded to the
// slice), so r <= 768 fits a block's 227 KB beside the ring
// (kernels/newton_schulz.py's APPLY_MAX_RANK, where the wrapper refuses a
// larger r). fused_step.py routes r <= 512 to the kernels.
//
// ns_gram loads the next chunk of its operands into registers while the
// current one is computed from shared memory, so the loads' latency overlaps
// the FMAs; the FMA order, and so every bit, is that of loading and
// computing in turn. Its 26 KB of shared memory do not depend on r.
#include <cstdint>

#include <cuda_runtime.h>

#include "mma.cuh"

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
namespace apply {

constexpr int BM = 128;                        // rows of a row block
constexpr int BN = 64;                         // columns of X and Y per CTA
constexpr int TM = 8;                          // rows per thread
constexpr int TN = 8;                          // columns per thread
constexpr int kThreads = BM * BN / (TM * TN);  // 128
constexpr int TX = BN / TN;                    // thread columns, a multiple of 8
constexpr int BK = 16;                         // k slice
constexpr int kMinBlocks = 3;                  // CTAs per SM at r = 128
constexpr int kLdT = BM + 4;                   // row stride of the transposed P slice

// the P ring; X's stripe follows it in shared memory, (r padded to BK) x BN
struct Ring {
  float p32[2][BM][BK];   // P slices as they arrive: rows of P
  float pt[2][BK][kLdT];  // the same, transposed: k rows of 128 P rows
};

size_t smem_bytes(int r) {
  return sizeof(Ring) + sizeof(float) * BN * ((static_cast<size_t>(r) + BK - 1) / BK * BK);
}

template <int W>
__device__ __forceinline__ void copy_piece(float* dst, const float* src, bool ok) {
  if constexpr (W == 4)
    mma::cp_async16(dst, src, ok);
  else
    mma::cp_async4(dst, src, ok);
}

// A thread's pieces of k slice k0: W = 4 (16-byte cp.async) or 1 (4-byte).
// Piece e of P is row e / (BK / W), column W * (e % (BK / W)) of the slice;
// with_x, piece e of X is row e / (BN / W), column W * (e % (BN / W)), into
// the stripe's row k0 + e / (BN / W). The thread that copies a piece of P
// also transposes it (transpose_slice).
template <int W>
__device__ __forceinline__ void copy_slice(Ring& rg, float* xs, int slot, const float* pb,
                                           const float* xb, int r, int m, int row0, int col0,
                                           int k0, bool with_x) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int rr = e / (BK / W), c = W * (e % (BK / W));
    const bool ok = row0 + rr < r && k0 + c < r;
    const float* src = ok ? pb + static_cast<long long>(row0 + rr) * r + k0 + c : pb;
    copy_piece<W>(&rg.p32[slot][rr][c], src, ok);
  }
  if (!with_x) return;
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / (BN / W), c = W * (e % (BN / W));
    const bool ok = k0 + k < r && col0 + c < m;
    const float* src = ok ? xb + static_cast<long long>(k0 + k) * m + col0 + c : xb;
    copy_piece<W>(&xs[(k0 + k) * BN + c], src, ok);
  }
}

template <int W>
__device__ __forceinline__ void transpose_slice(Ring& rg, int buf) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int rr = e / (BK / W), c = W * (e % (BK / W));
    if constexpr (W == 4) {
      const float4 v = *reinterpret_cast<const float4*>(&rg.p32[buf][rr][c]);
      rg.pt[buf][c][rr] = v.x;
      rg.pt[buf][c + 1][rr] = v.y;
      rg.pt[buf][c + 2][rr] = v.z;
      rg.pt[buf][c + 3][rr] = v.w;
    } else {
      rg.pt[buf][c][rr] = rg.p32[buf][rr][c];
    }
  }
}

// the thread's local row i < TM and column j < TN: groups of 4, the groups
// BM / (TM / 4) rows and BN / (TN / 4) columns apart
__device__ __forceinline__ int local_row(int ty, int i) {
  return (BM / (TM / 4)) * (i / 4) + 4 * ty + i % 4;
}
__device__ __forceinline__ int local_col(int tx, int j) {
  return (BN / (TN / 4)) * (j / 4) + 4 * tx + j % 4;
}

// three CTAs per SM at r = 128: at most 170 registers a thread
template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ns_apply_kernel(const float* __restrict__ x, const float* __restrict__ p,
                float* __restrict__ y, float a, int r, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring& rg = *reinterpret_cast<Ring*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + sizeof(Ring));

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * BN;
  const float* xb = x + static_cast<long long>(b) * r * m;
  const float* pb = p + static_cast<long long>(b) * r * r;
  float* yb = y + static_cast<long long>(b) * r * m;
  // a warp is 4 thread rows x 8 thread columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);
  const int slices = (r + BK - 1) / BK;

  for (int row0 = 0; row0 < r; row0 += BM) {
    const bool with_x = row0 == 0;  // the first row block brings the stripe
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    copy_slice<W>(rg, xs, 0, pb, xb, r, m, row0, col0, 0, with_x);
    mma::cp_async_commit();
    for (int kt = 0; kt < slices; ++kt) {
      const int buf = kt & 1;
      mma::cp_async_wait<0>();  // this thread's pieces of slice kt
      transpose_slice<W>(rg, buf);
      // every piece of slice kt is in place; every thread is done with
      // slice kt - 1, so its ring slot and transposed buffer are free
      __syncthreads();
      if (kt + 1 < slices)
        copy_slice<W>(rg, xs, buf ^ 1, pb, xb, r, m, row0, col0, (kt + 1) * BK, with_x);
      mma::cp_async_commit();
      const float* xk = xs + kt * BK * BN;
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int h = 0; h < TM / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(&rg.pt[buf][k][local_row(ty, 4 * h)]);
          av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z, av[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(&xk[k * BN + local_col(tx, 4 * h)]);
          bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z, bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // epilogue: Y = a X + P X with X's rows from the stripe
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + local_row(ty, i);
      if (row >= r) continue;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const int lc = local_col(tx, 4 * h);
        const float4 xv = *reinterpret_cast<const float4*>(&xs[row * BN + lc]);
        const float4 v = make_float4(__fadd_rn(__fmul_rn(a, xv.x), acc[i][4 * h]),
                                     __fadd_rn(__fmul_rn(a, xv.y), acc[i][4 * h + 1]),
                                     __fadd_rn(__fmul_rn(a, xv.z), acc[i][4 * h + 2]),
                                     __fadd_rn(__fmul_rn(a, xv.w), acc[i][4 * h + 3]));
        const int col = col0 + lc;
        float* dst = yb + static_cast<long long>(row) * m + col;
        if (W == 4) {
          if (col < m) *reinterpret_cast<float4*>(dst) = v;
        } else {
          if (col < m) dst[0] = v.x;
          if (col + 1 < m) dst[1] = v.y;
          if (col + 2 < m) dst[2] = v.z;
          if (col + 3 < m) dst[3] = v.w;
        }
      }
    }
    // every thread is done with the ring before the next row block's copies
    __syncthreads();
  }
}

}  // namespace apply

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

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

// 16-byte copies need r % 4 == 0, m % 4 == 0 and X, P, Y on 16 bytes;
// otherwise the same kernel copies 4-byte pieces. An r whose stripe does not
// fit a block's shared memory fails in cudaFuncSetAttribute.
extern "C" int repro_ns_apply(const float* x, const float* p, float* y, float a, int batch,
                              int r, int m, void* stream) {
  if (batch <= 0 || r <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = apply::smem_bytes(r);
  const auto launch = [&](auto kernel) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    kernel<<<dim3((m + apply::BN - 1) / apply::BN, batch), apply::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(x, p, y, a, r, m);
    return static_cast<int>(cudaGetLastError());
  };
  return r % 4 == 0 && m % 4 == 0 && aligned(x, 16) && aligned(p, 16) && aligned(y, 16)
             ? launch(apply::ns_apply_kernel<4>)
             : launch(apply::ns_apply_kernel<1>);
}
