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
#include "mma.cuh"

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
      As[c][r] =
          (gr < m && gc < n) ? gb[static_cast<long long>(gr) * n + gc] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < (BK * BN) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / BN, c = e % BN;
      const int qr = k0 + r, qc = col0 + c;
      Bs[r][c] =
          (qr < n && qc < n) ? q[static_cast<long long>(qr) * n + qc] : 0.f;
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

}  // namespace

extern "C" int repro_dct_project(const float* g, const float* q, float* s, float* partial,
                                 float* norms, int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dct_project_kernel<<<project_grid(batch, m, n), kThreads, 0, st>>>(g, q, s, partial, m, n);
  return sum_row_blocks(partial, norms, batch, m, n, st);
}

namespace {

template <int W>
int project_bf16(const float* g, const float* q, float* s, float* partial, float* norms,
                 int batch, int m, int n, cudaStream_t st) {
  auto kernel = tc::dct_project_bf16_kernel<W>;
  constexpr int smem = static_cast<int>(sizeof(tc::Smem));
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<project_grid(batch, m, n), tc::kThreads, smem, st>>>(g, q, s, partial, m, n);
  return sum_row_blocks(partial, norms, batch, m, n, st);
}

}  // namespace

// 16-byte copies need n % 4 == 0 and both operands on 16 bytes; otherwise
// the same kernel copies 4-byte pieces
extern "C" int repro_dct_project_bf16(const float* g, const float* q, float* s, float* partial,
                                      float* norms, int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return vec ? project_bf16<4>(g, q, s, partial, norms, batch, m, n, st)
             : project_bf16<1>(g, q, s, partial, norms, batch, m, n, st);
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
