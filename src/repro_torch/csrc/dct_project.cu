// Fused basis projection S = G @ Q plus the squared column norms of S,
// for Hopper, in three precisions. Replaces
// repro/kernels/dct_project.py::_kernel (fp32, and bf16 with cast=bfloat16)
// and ::_kernel_q8 (int8).
//
// fp32. Bound: fp32 FMA rate. The product is 2*m*n*n flops per layer
// against 4*(m*n + n*n + m*n + n) bytes, far above the card's fp32 balance,
// and the tolerance of the fp32 path is exact fp32
// (LOWP_ERROR_BOUNDS["fp32"] == 0), so no TF32 tensor-core path is allowed.
// Design: a pipelined SIMT GEMM. Each CTA of 256 threads owns a 128 x 256
// tile of S for one layer (batch index in blockIdx.z), and each thread an
// 8 x 16 register tile accumulated with IEEE fp32 FMA, k ascending (the
// same bits on every launch). G and Q arrive by cp.async (16-byte pieces;
// 4-byte ones where n % 4 or an address forbids 16) into a 2-stage ring of
// 16-deep k slices. Q's slice is used as it arrives (k rows of 256
// columns); each thread transposes the pieces of G it copied itself into a
// double-buffered k-major tile (rows padded to 132 floats), so one barrier
// per slice suffices. Per k step a thread reads its 8 rows (two groups of
// 4, 64 apart) and its 16 columns (four groups of 4, 64 apart) as 6
// float4s for 128 FMAs; a warp is 4 thread rows x 8 thread columns, so
// each read covers 64 or 128 contiguous bytes: no bank conflicts. Up to
// 255 registers a thread, 81 KB of shared memory, one CTA per SM. On this
// card (NVIDIA H100 80GB HBM3, 700 W; its FFMA rate 56.7 TFLOP/s by
// scripts/dct_project_probe.py --rates) these were slower in development
// runs: 128 x 128 tiles (8 x 8 or 8 x 16 per thread), G read row-major
// along k without the transpose, 3 or 4 stages, 8- or 32-deep slices, a k
// loop not fully unrolled, the columns outer in the FMA loop.
//
// bf16. The function: each fp32 operand rounded once to bf16 (nearest
// even), exact products, fp32 sums; fp32 S. Bound: bytes (fp32 G read and
// fp32 S written, 8 bytes per element of S against 2 * n bf16 flops, below
// the card's bf16 balance at n = 1024, but only if the product runs on the
// tensor cores). Design: its own kernel on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulators). A CTA of 8 warps owns a 128 x 128 tile of S (a warp
// 64 x 32: 4 x 4 mma tiles); the fp32 G and Q tiles of 32-deep k slices
// arrive by cp.async into a 2-stage fp32 ring, each thread copying 16-byte
// pieces (4-byte pieces where n % 4 or an address forbids 16) and then
// rounding the same pieces to bf16 (__floats2bfloat162_rn: the plain
// version's bf16_round, two at a time) into a double-buffered bf16 tile
// that ldmatrix reads (Q through ldmatrix.trans), rows padded 16 bytes
// against bank conflicts. A thread rounds only what it copied itself, so
// one barrier per k slice suffices: the one before the mma reads. The
// tensor cores' fp32 sums are not a sequence of IEEE adds, so S differs
// from the plain version by more than an order of fp32 sums would (the
// bound is chip_smoke.py's LOWP_TC_RTOL).
//
// int8 takes G's codes per row (batch, m, n) with row scales sg (batch, m)
// and Q^T's codes (n, n) -- row j holds column j of Q, quantized per
// column -- with scales sq (n). The wrapper quantizes, one launch per
// operand (quant_ef.cu). Bound: bytes (the fp32 S written dominates; at the
// int8 tensor-core rate the product is cheap). Design: the bf16 kernel's
// shape on mma.sync.m16n8k32 (int8 in, int32 accumulators): a CTA of 8
// warps owns a 128 x 128 tile of S (a warp 64 x 32: 4 x 4 mma tiles), the
// codes of 128-deep k slices arrive by cp.async (16-byte pieces; 4-byte
// ones, or single bytes, where n or an address forbids) into a 2-stage
// ring, one barrier per slice, rows padded to 144 bytes against bank
// conflicts (74 KB, 2 CTAs per SM; 64-deep slices in 2-4 stages, and
// 128 x 256 tiles of 16 warps at one CTA per SM, were slower in
// development runs on an H100). Because B is stored as
// Q^T (k contiguous for each column of S), a plain ldmatrix.x4 yields B
// fragments (4 consecutive k of one column per register) exactly as it
// yields A fragments from G's rows;
// ldmatrix.trans moves only 16-bit elements and could not transpose
// bytes. Every partial sum is an integer below 127^2 * n < 2^31 (the
// wrapper checks n), so int32 accumulation is exact in any order. The
// epilogue is (float(acc) * sg[i]) * sq[j] in that order, as the TPU
// kernel's, so S equals the plain version bit for bit. k past n is padded
// with zero codes, which add 0.
//
// Norms (every precision): the TPU kernel keeps each column's norm resident
// across a sequential sweep over row blocks. Row blocks run in parallel
// here, so the epilogue writes each CTA's column sums of squares to a
// partial buffer (batch, row_blocks, n), and a second kernel sums it over
// the row blocks in a fixed order. No atomics: the top-r selection
// downstream flips on a 1-ulp difference, so the sum must not depend on
// scheduling. The int8 norms are those of the dequantized S.
//
// Ragged m and n are masked in the loads (zero-filled) and the stores.
#include <cstdint>

#include <cuda_runtime.h>

#include "lowp.cuh"
#include "mma.cuh"

namespace {

// every precision's CTA rows (the partial-norm buffer has m / BM row
// blocks); the int8 and bf16 kernels' CTA columns and threads
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int kThreads = 256;

// fp32 on the SIMT cores
namespace f32 {

constexpr int BN = 256;                      // columns per CTA (rows: BM)
constexpr int TM = 8;                        // rows per thread
constexpr int TN = 16;                       // columns per thread
constexpr int kThreads = BM * BN / (TM * TN);
constexpr int TY = BM / TM;                  // thread rows
constexpr int TX = BN / TN;                  // thread columns
constexpr int BK = 16;                       // k slice
constexpr int kStages = 2;                   // slices in flight
constexpr int kLdT = BM + 4;                 // row stride (floats) of the transposed G tile

struct Smem {
  float a32[kStages][BM][BK];  // G slices as they arrive: rows of G
  float at[2][BK][kLdT];       // the same, transposed: k rows of 128 G rows
  float b[kStages][BK][BN];    // Q slices: rows of Q
  float col_sq[TY][BN];
};

// A thread's pieces of one k slice: W = 4 (16-byte cp.async) or 1 (4-byte).
// Piece e of G is row e / (BK / W), column W * (e % (BK / W)); of Q, row
// e / (BN / W), column W * (e % (BN / W)). The thread that copies a piece
// of G also transposes it (transpose_slice).
template <int W>
__device__ __forceinline__ void copy_slice(Smem& sm, int slot, const float* gb,
                                           const float* q, int m, int n, int row0,
                                           int col0, int k0) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BK / W), c = W * (e % (BK / W));
    const bool ok = row0 + r < m && k0 + c < n;
    const float* src = ok ? gb + static_cast<long long>(row0 + r) * n + k0 + c : gb;
    if constexpr (W == 4)
      mma::cp_async16(&sm.a32[slot][r][c], src, ok);
    else
      mma::cp_async4(&sm.a32[slot][r][c], src, ok);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BN / W), c = W * (e % (BN / W));
    const bool ok = k0 + r < n && col0 + c < n;
    const float* src = ok ? q + static_cast<long long>(k0 + r) * n + col0 + c : q;
    if constexpr (W == 4)
      mma::cp_async16(&sm.b[slot][r][c], src, ok);
    else
      mma::cp_async4(&sm.b[slot][r][c], src, ok);
  }
}

template <int W>
__device__ __forceinline__ void transpose_slice(Smem& sm, int slot, int buf) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BK / W), c = W * (e % (BK / W));
    if constexpr (W == 4) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.a32[slot][r][c]);
      sm.at[buf][c][r] = x.x;
      sm.at[buf][c + 1][r] = x.y;
      sm.at[buf][c + 2][r] = x.z;
      sm.at[buf][c + 3][r] = x.w;
    } else {
      sm.at[buf][c][r] = sm.a32[slot][r][c];
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

// one CTA per SM: up to 255 registers a thread
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
dct_project_kernel(const float* __restrict__ g, const float* __restrict__ q,
                   float* __restrict__ s, float* __restrict__ partial, int m, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* gb = g + static_cast<long long>(b) * m * n;
  float* sb = s + static_cast<long long>(b) * m * n;
  // a warp is 4 thread rows x 8 thread columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int slices = (n + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < slices) copy_slice<W>(sm, st, gb, q, m, n, row0, col0, st * BK);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    const int slot = kt % kStages, buf = kt & 1;
    mma::cp_async_wait<kStages - 2>();  // this thread's pieces of slice kt
    transpose_slice<W>(sm, slot, buf);
    // every piece of slice kt is in place; every thread is done with slice
    // kt - 1, so its ring slot and the other transposed buffer are free
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < slices) copy_slice<W>(sm, next % kStages, gb, q, m, n, row0, col0, next * BK);
    mma::cp_async_commit();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.at[buf][k][local_row(ty, 4 * h)]);
        av[4 * h] = a.x, av[4 * h + 1] = a.y, av[4 * h + 2] = a.z, av[4 * h + 3] = a.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&sm.b[slot][k][local_col(tx, 4 * h)]);
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z, bv[4 * h + 3] = v.w;
      }
      // rows in order, the columns of odd rows backwards (consecutive FMAs
      // share an operand at the turn); each output's k order is ascending
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          const int j = (i & 1) ? TN - 1 - jj : jj;
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
  }

  // epilogue: store S, and this thread's column sums of squares over its
  // rows (rows past m and columns past n hold exact zeros: their loads were
  // zero-filled), then over the 16 thread rows in order
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) sq = fmaf(acc[i][j], acc[i][j], sq);
    sm.col_sq[ty][local_col(tx, j)] = sq;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + local_row(ty, i);
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = col0 + local_col(tx, 4 * h);
      float* dst = sb + static_cast<long long>(row) * n + col;
      if (W == 4) {
        if (col < n)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) dst[j] = acc[i][4 * h + j];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += kThreads) {
    if (col0 + c >= n) break;
    float total = 0.f;
    for (int t = 0; t < TY; ++t) total = __fadd_rn(total, sm.col_sq[t][c]);
    partial[(static_cast<long long>(b) * gridDim.y + blockIdx.y) * n + col0 + c] = total;
  }
}

}  // namespace f32

// int8 on the tensor cores
namespace i8 {

constexpr int BK = 128;       // k slice in codes (four m16n8k32 steps)
constexpr int kStages = 2;    // slices in flight
constexpr int kLd = BK + 16;  // padded row stride in bytes: ldmatrix rows on distinct banks

struct Smem {
  int8_t a[kStages][BM][kLd];  // G's codes: rows of G, k along a row
  int8_t b[kStages][BN][kLd];  // Q^T's codes: columns of S, k along a row
  float col_sq[2][BN];
};

// One operand's rows [row0, row0 + 128) of a k slice, rows past `rows`
// and codes past n zero-filled, in pieces of 16 or 4 bytes: by cp.async
// (W = 16, 4), or (W = 1, for an n or an address that allows neither) as
// byte loads packed into one shared store per 4 codes.
template <int W>
__device__ __forceinline__ void copy_rows(int8_t (*dst)[kLd], const int8_t* src, int rows,
                                          int n, int row0, int k0) {
  constexpr int kPiece = W == 16 ? 16 : 4;
#pragma unroll
  for (int i = 0; i < BM * BK / kPiece / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BK / kPiece), c = kPiece * (e % (BK / kPiece));
    const bool ok = row0 + r < rows && k0 + c < n;
    const int8_t* p = ok ? src + static_cast<long long>(row0 + r) * n + k0 + c : src;
    if constexpr (W == 16)
      mma::cp_async16(&dst[r][c], p, ok);
    else if constexpr (W == 4)
      mma::cp_async4(&dst[r][c], p, ok);
    else
      *reinterpret_cast<int*>(&dst[r][c]) = ok ? q8::load4(p, n - k0 - c, false) : 0;
  }
}

// two CTAs per SM with 16-byte copies, one with the narrower ones (more
// pieces per thread)
template <int W>
__global__ void __launch_bounds__(kThreads, W == 16 ? 2 : 1)
dct_project_q8_kernel(const int8_t* __restrict__ g, const int8_t* __restrict__ qt,
                      const float* __restrict__ sg, const float* __restrict__ sq,
                      float* __restrict__ s, float* __restrict__ partial, int m, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int8_t* gb = g + static_cast<long long>(b) * m * n;
  const float* sgb = sg + static_cast<long long>(b) * m;
  float* sb = s + static_cast<long long>(b) * m * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 64 x 32 tile
  const int g8 = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int slices = (n + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < slices) {
      copy_rows<W>(sm.a[st], gb, m, n, row0, st * BK);
      copy_rows<W>(sm.b[st], qt, n, n, col0, st * BK);
    }
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    mma::cp_async_wait<kStages - 2>();  // this thread's pieces of slice kt
    __syncthreads();  // everyone's pieces; and slice kt - 1's slot is read out
    const int next = kt + kStages - 1;
    if (next < slices) {
      copy_rows<W>(sm.a[next % kStages], gb, m, n, row0, next * BK);
      copy_rows<W>(sm.b[next % kStages], qt, n, n, col0, next * BK);
    }
    mma::cp_async_commit();
    const int slot = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned af[4][4], bq[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        mma::ldmatrix_x4(af[mt], &sm.a[slot][wm * 64 + mt * 16 + (lane & 15)]
                                        [ks * 32 + (lane >> 4) * 16]);
      // matrix i = lane / 8: columns 8 (i / 2) + lane % 8 of the pair's 16,
      // k bytes 16 (i % 2): registers {b0, b1} of column tile 2 np, then 2 np + 1
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        mma::ldmatrix_x4(r, &sm.b[slot][wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)]
                                       [ks * 32 + ((lane >> 3) & 1) * 16]);
        bq[2 * np][0] = r[0];
        bq[2 * np][1] = r[1];
        bq[2 * np + 1][0] = r[2];
        bq[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma::mma_s8(acc[mt][nt], af[mt], bq[nt][0], bq[nt][1]);
    }
  }

  // epilogue: S = (float(acc) * sg[row]) * sq[col]; column sums of squares
  // over the warp's 64 rows (rows past m and columns past n hold exact
  // zeros: their codes were zero-filled and their scales read as 0), then
  // over the two warps along M in order
  float rs[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + wm * 64 + mt * 16 + g8 + 8 * hf;
      rs[mt][hf] = row < m ? sgb[row] : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int lc = wn * 32 + nt * 8 + 2 * t;
    const int col = col0 + lc;
    const float cs0 = col < n ? sq[col] : 0.f;
    const float cs1 = col + 1 < n ? sq[col + 1] : 0.f;
    float sqs[2] = {0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + wm * 64 + mt * 16 + g8 + 8 * hf;
        const float x0 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hf]), rs[mt][hf]), cs0);
        const float x1 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hf + 1]), rs[mt][hf]), cs1);
        sqs[0] = fmaf(x0, x0, sqs[0]);
        sqs[1] = fmaf(x1, x1, sqs[1]);
        if (row >= m) continue;
        float* dst = sb + static_cast<long long>(row) * n + col;
        if (W >= 4 && col < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          if (col < n) dst[0] = x0;
          if (col + 1 < n) dst[1] = x1;
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sqs[i] += __shfl_xor_sync(0xffffffffu, sqs[i], off);
      if (g8 == 0) sm.col_sq[wm][lc + i] = sqs[i];
    }
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < BN && col0 + c < n)
    partial[(static_cast<long long>(b) * gridDim.y + blockIdx.y) * n + col0 + c] =
        __fadd_rn(sm.col_sq[0][c], sm.col_sq[1][c]);
}

}  // namespace i8

// bf16 on the tensor cores: tile shapes (BM = BN = 128 as above, so the
// partial-norm buffer has the same row blocks)
namespace tc {

constexpr int BK = 32;          // k slice
constexpr int kThreads = 256;   // 8 warps: 2 along M (64 rows) x 4 along N (32 columns)
constexpr int kStages = 2;      // fp32 slices in flight (the loop flips slot ^ 1)
constexpr int kLdA = BK + 8;    // bf16 row stride of the G tile
constexpr int kLdB = BN + 8;    // bf16 row stride of the Q tile

struct Smem {
  float a32[kStages][BM][BK];   // G slices as they arrive
  float b32[kStages][BK][BN];   // Q slices
  __nv_bfloat16 a16[2][BM][kLdA];
  __nv_bfloat16 b16[2][BK][kLdB];
  float col_sq[2][BN];
};

// A thread's pieces of one k slice: W = 4 (16-byte cp.async) or 1 (4-byte).
// Piece e of G is row e / (BK / W), column W * (e % (BK / W)); of Q, row
// e / (BN / W), column W * (e % (BN / W)). The same thread copies a piece
// and rounds it.
template <int W>
__device__ __forceinline__ void copy_slice(Smem& sm, int slot, const float* gb,
                                           const float* q, int m, int n, int row0,
                                           int col0, int k0) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BK / W), c = W * (e % (BK / W));
    const bool ok = row0 + r < m && k0 + c < n;
    const float* src = ok ? gb + static_cast<long long>(row0 + r) * n + k0 + c : gb;
    if constexpr (W == 4)
      mma::cp_async16(&sm.a32[slot][r][c], src, ok);
    else
      mma::cp_async4(&sm.a32[slot][r][c], src, ok);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BN / W), c = W * (e % (BN / W));
    const bool ok = k0 + r < n && col0 + c < n;
    const float* src = ok ? q + static_cast<long long>(k0 + r) * n + col0 + c : q;
    if constexpr (W == 4)
      mma::cp_async16(&sm.b32[slot][r][c], src, ok);
    else
      mma::cp_async4(&sm.b32[slot][r][c], src, ok);
  }
}

template <int W>
__device__ __forceinline__ void round_slice(Smem& sm, int slot, int buf) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BK / W), c = W * (e % (BK / W));
    if constexpr (W == 4) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.a32[slot][r][c]);
      *reinterpret_cast<uint2*>(&sm.a16[buf][r][c]) =
          make_uint2(mma::pack_bf16(x.x, x.y), mma::pack_bf16(x.z, x.w));
    } else {
      sm.a16[buf][r][c] = __float2bfloat16_rn(sm.a32[slot][r][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (BN / W), c = W * (e % (BN / W));
    if constexpr (W == 4) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.b32[slot][r][c]);
      *reinterpret_cast<uint2*>(&sm.b16[buf][r][c]) =
          make_uint2(mma::pack_bf16(x.x, x.y), mma::pack_bf16(x.z, x.w));
    } else {
      sm.b16[buf][r][c] = __float2bfloat16_rn(sm.b32[slot][r][c]);
    }
  }
}

// two CTAs per SM (128 registers) with 16-byte copies; the 4-byte copies'
// address arithmetic would spill there, so one
template <int W>
__global__ void __launch_bounds__(kThreads, W == 4 ? 2 : 1)
dct_project_bf16_kernel(const float* __restrict__ g, const float* __restrict__ q,
                        float* __restrict__ s, float* __restrict__ partial, int m, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* gb = g + static_cast<long long>(b) * m * n;
  float* sb = s + static_cast<long long>(b) * m * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 64 x 32 tile
  const int g8 = lane >> 2, t = lane & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int slices = (n + BK - 1) / BK;
  copy_slice<W>(sm, 0, gb, q, m, n, row0, col0, 0);
  mma::cp_async_commit();
  for (int kt = 0; kt < slices; ++kt) {
    const int slot = kt & 1;
    mma::cp_async_wait<kStages - 2>();  // this thread's pieces of slice kt
    if (kt + 1 < slices) copy_slice<W>(sm, slot ^ 1, gb, q, m, n, row0, col0, (kt + 1) * BK);
    mma::cp_async_commit();
    round_slice<W>(sm, slot, slot);
    __syncthreads();  // the rounded slice is complete; buffer slot ^ 1 is free again
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      unsigned af[4][4], bq[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        mma::ldmatrix_x4(af[mt], &sm.a16[slot][wm * 64 + mt * 16 + (lane & 15)]
                                        [ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        mma::ldmatrix_x4_trans(r, &sm.b16[slot][ks * 16 + (lane & 15)]
                                         [wn * 32 + np * 16 + (lane >> 4) * 8]);
        bq[2 * np][0] = r[0];
        bq[2 * np][1] = r[1];
        bq[2 * np + 1][0] = r[2];
        bq[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma::mma_bf16(acc[mt][nt], af[mt], bq[nt][0], bq[nt][1]);
    }
  }

  // epilogue: store S; column sums of squares over the warp's 64 rows
  // (rows past m and columns past n hold exact zeros: their loads were
  // zero-filled), then over the two warps along M in order
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int lc = wn * 32 + nt * 8 + 2 * t;
    const int col = col0 + lc;
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + wm * 64 + mt * 16 + g8 + 8 * hf;
        const float x0 = acc[mt][nt][2 * hf], x1 = acc[mt][nt][2 * hf + 1];
        sq[0] = fmaf(x0, x0, sq[0]);
        sq[1] = fmaf(x1, x1, sq[1]);
        if (row >= m) continue;
        float* dst = sb + static_cast<long long>(row) * n + col;
        if (W == 4 && col < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          if (col < n) dst[0] = x0;
          if (col + 1 < n) dst[1] = x1;
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
      if (g8 == 0) sm.col_sq[wm][lc + i] = sq[i];
    }
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < BN && col0 + c < n)
    partial[(static_cast<long long>(b) * gridDim.y + blockIdx.y) * n + col0 + c] =
        __fadd_rn(sm.col_sq[0][c], sm.col_sq[1][c]);
}

}  // namespace tc

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

dim3 project_grid(int batch, int m, int n, int cols) {
  return dim3((n + cols - 1) / cols, (m + BM - 1) / BM, batch);
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

// a kernel with more than 48 KB of dynamic shared memory, launched on the
// projection grid, then the norms' second stage
template <typename Kernel, typename... Args>
int launch_projection(Kernel kernel, int threads, size_t smem, int cols, int batch, int m, int n,
                      const float* partial, float* norms, cudaStream_t st, Args... args) {
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<project_grid(batch, m, n, cols), threads, smem, st>>>(args...);
  return sum_row_blocks(partial, norms, batch, m, n, st);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// 16-byte copies need n % 4 == 0 and both operands on 16 bytes; otherwise
// the same kernel copies 4-byte pieces
extern "C" int repro_dct_project(const float* g, const float* q, float* s, float* partial,
                                 float* norms, int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto launch = [&](auto kernel) {
    return launch_projection(kernel, f32::kThreads, sizeof(f32::Smem), f32::BN, batch, m, n,
                             partial, norms, static_cast<cudaStream_t>(stream), g, q, s, partial,
                             m, n);
  };
  return n % 4 == 0 && aligned(g, 16) && aligned(q, 16) ? launch(f32::dct_project_kernel<4>)
                                                         : launch(f32::dct_project_kernel<1>);
}

// 16-byte copies need n % 4 == 0 and both operands on 16 bytes; otherwise
// the same kernel copies 4-byte pieces
extern "C" int repro_dct_project_bf16(const float* g, const float* q, float* s, float* partial,
                                      float* norms, int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto launch = [&](auto kernel) {
    return launch_projection(kernel, tc::kThreads, sizeof(tc::Smem), BN, batch, m, n, partial,
                             norms, static_cast<cudaStream_t>(stream), g, q, s, partial, m, n);
  };
  return n % 4 == 0 && aligned(g, 16) && aligned(q, 16) ? launch(tc::dct_project_bf16_kernel<4>)
                                                         : launch(tc::dct_project_bf16_kernel<1>);
}

// int8 on G's codes and Q^T's: 16-byte copies where n % 16 == 0 and both
// code arrays lie on 16 bytes, 4-byte ones where n % 4 == 0 on 4, else
// single bytes
extern "C" int repro_dct_project_q8t(const int8_t* g, const int8_t* qt, const float* sg,
                                     const float* sq, float* s, float* partial, float* norms,
                                     int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto launch = [&](auto kernel) {
    return launch_projection(kernel, kThreads, sizeof(i8::Smem), BN, batch, m, n, partial,
                             norms, static_cast<cudaStream_t>(stream), g, qt, sg, sq, s, partial,
                             m, n);
  };
  if (n % 16 == 0 && aligned(g, 16) && aligned(qt, 16))
    return launch(i8::dct_project_q8_kernel<16>);
  if (n % 4 == 0 && aligned(g, 4) && aligned(qt, 4)) return launch(i8::dct_project_q8_kernel<4>);
  return launch(i8::dct_project_q8_kernel<1>);
}
