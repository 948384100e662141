// Column-gather back-projection for Hopper, one operand or two:
//   o1 = b1 @ Qt[idx, :]             (colgather_matmul)
//   o1, o2 = b1, b2 @ Qt[idx, :]     (colgather_matmul_dual)
// with b1, b2 (batch, m, r), Qt = Q^T (n, n) contiguous, idx (batch, r)
// int32 per layer, in three precisions. Replaces
// repro/kernels/colgather_matmul.py::_kernel and ::_kernel_dual (fp32, and
// bf16 with cast=bfloat16) and ::_kernel_q8 and ::_kernel_dual_q8 (int8);
// each precision is one template instantiated for one and for two operands.
//
// fp32. Bound: fp32 FMA rate at r = 128 (2*m*n*r flops per operand and
// layer against the (m, n) fp32 outputs). The TPU kernel copies a whole
// (n, bn) stripe of Qt into VMEM and gathers r rows out of it. Here each
// CTA, for its column tile and layer, reads idx[b, :] itself and gathers
// the selected rows Qt[idx[k], j0:j0+128] straight from global memory
// (coalesced along the column) into shared memory, 8 rows of the r at a
// time, so the gathered (r, n) factor never exists in device memory. The
// next slices of b and of the gathered rows are loaded into registers while
// the current ones are computed from shared memory (the FMA order is
// unchanged). The dual entry point takes both products from the one
// gathered tile: each thread keeps a 4x8 fp32 register tile per operand.
// The shared-memory layout follows dct_project.cu (two groups of 4 columns
// 64 apart, transposed and padded A slices).
//
// bf16. The function: each fp32 operand rounded once to bf16 (nearest
// even), exact products, fp32 sums; fp32 outputs. Bound: bytes (4 m n bytes
// of fp32 output per operand against 2 m n r flops: at r = 128, 64 flops a
// byte, below the card's bf16 balance of ~295 once the products run on the
// tensor cores). Design: the bf16 dct_project kernel (dct_project.cu) with a
// gathered B, on mma.sync.m16n8k16 (bf16 in, fp32 accumulators). A CTA of 8
// warps owns a 128 x 128 tile of each output (a warp 64 x 32: 4 x 4 mma tiles
// per operand). The CTA's rows of each b (A: row-major, k = r along a row)
// and the selected rows of Qt (B: row k of the tile is Qt[idx[k], col0 ..
// col0 + 128), copied from that row's address; an index outside [0, n)
// copies zeros) arrive by cp.async in 32-deep k slices into a 2-stage fp32
// ring (16-byte pieces; 4-byte ones where r % 4, n % 4 or an address
// forbids 16), and each thread rounds the pieces it copied itself to bf16
// (__floats2bfloat162_rn) into a double-buffered tile that ldmatrix reads
// (the gathered rows through ldmatrix.trans), so one barrier per slice
// suffices. A ragged r reads zeros past r. The dual instance takes both
// products from each B fragment it loads: two accumulator sets, 128 fp32
// registers a thread and 153 KB of shared memory, one CTA per SM (the single
// instance: 64 registers of sums and 101 KB, two CTAs per SM). The epilogue
// stages each output's tile in shared memory (rows padded against bank
// conflicts) and writes it as 16-byte stores, a warp to each 512-byte
// row (4-byte stores where n % 4 or an address forbids). The
// tensor cores' fp32 sums are not a sequence of IEEE adds, so the outputs
// differ from the plain version by more than an order of fp32 sums would
// (chip_smoke.py's LOWP_TC_RTOL). The single instance's output equals the
// dual's first bit for bit (the same mma sequence), and a relaunch gives
// the same bits.
//
// int8 takes Qt quantized per row (codes qt (n, n)) and each b quantized
// per row after the selected rows' scales were folded into it (codes b
// (batch, m, r), scales sb (batch, m)); the wrapper quantizes. The kernel
// gathers the selected *int8* rows into shared memory, packed along k by a
// 4x4 byte transpose, accumulates exactly in int32 with __dp4a (|sum| <=
// 127^2 * r < 2^31), and writes float(acc) * sb[i]: the plain version's
// result bit for bit. Bound: bytes (the fp32 outputs). An r that is not a
// multiple of 32 is padded with zero codes.
//
// An index outside [0, n) gathers a zero row (the load is masked), so a bad
// index cannot read outside Qt. Ragged m, n and r are masked.
#include <cstdint>

#include <cuda_runtime.h>

#include "lowp.cuh"
#include "mma.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;

// at least 2 CTAs per SM: the prefetch registers of the dual instance would
// otherwise leave one
template <int kOps>
__global__ void __launch_bounds__(kThreads, 2)
colgather_matmul_kernel(const float* __restrict__ b1, const float* __restrict__ b2,
                        const float* __restrict__ qt, const int* __restrict__ idx,
                        float* __restrict__ o1, float* __restrict__ o2, int m, int r, int n) {
  __shared__ __align__(16) float A1[BK][BM + kPad];  // b1 slice, transposed
  __shared__ __align__(16) float A2[kOps == 2 ? BK : 1][BM + kPad];  // b2 slice, transposed
  __shared__ __align__(16) float Bs[BK][BN];         // gathered rows of Qt

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long a_off = static_cast<long long>(b) * m * r;
  const long long o_off = static_cast<long long>(b) * m * n;
  const int* idx_b = idx + static_cast<long long>(b) * r;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc1[4][8], acc2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc1[i][j] = 0.f;
      acc2[i][j] = 0.f;
    }

  // the next slices are loaded into registers while this one is computed
  constexpr int kLoadsA = (BM * BK) / kThreads;
  constexpr int kLoadsB = (BK * BN) / kThreads;
  float n1[kLoadsA], n2[kLoadsA], nq[kLoadsB];
  auto load = [&](int k0) {
#pragma unroll
    for (int t = 0; t < kLoadsA; ++t) {
      const int e = tid + t * kThreads;
      const int gr = row0 + e / BK, gc = k0 + e % BK;
      const bool ok = gr < m && gc < r;
      const long long off = a_off + static_cast<long long>(gr) * r + gc;
      n1[t] = ok ? b1[off] : 0.f;
      if constexpr (kOps == 2) n2[t] = ok ? b2[off] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kLoadsB; ++t) {
      const int e = tid + t * kThreads;
      const int k = k0 + e / BN, col = col0 + e % BN;
      float v = 0.f;
      if (k < r && col < n) {
        const int src = idx_b[k];
        if (src >= 0 && src < n)
          v = qt[static_cast<long long>(src) * n + col];
      }
      nq[t] = v;
    }
  };
  load(0);
  for (int k0 = 0; k0 < r; k0 += BK) {
#pragma unroll
    for (int t = 0; t < kLoadsA; ++t) {
      const int e = tid + t * kThreads;
      A1[e % BK][e / BK] = n1[t];
      if constexpr (kOps == 2) A2[e % BK][e / BK] = n2[t];
    }
#pragma unroll
    for (int t = 0; t < kLoadsB; ++t) {
      const int e = tid + t * kThreads;
      Bs[e / BN][e % BN] = nq[t];
    }
    __syncthreads();
    if (k0 + BK < r) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 x1 = *reinterpret_cast<const float4*>(&A1[kk][ty * 4]);
      const float4 q0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 q1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a1[4] = {x1.x, x1.y, x1.z, x1.w};
      const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc1[i][j] = fmaf(a1[i], qv[j], acc1[i][j]);
      if constexpr (kOps == 2) {
        const float4 x2 = *reinterpret_cast<const float4*>(&A2[kk][ty * 4]);
        const float a2[4] = {x2.x, x2.y, x2.z, x2.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(a2[i], qv[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < n) {
        const long long off = o_off + static_cast<long long>(row) * n + col;
        o1[off] = acc1[i][j];
        if constexpr (kOps == 2) o2[off] = acc2[i][j];
      }
    }
  }
}

// int8: b codes (batch, m, r) with row scales sb (batch, m), Qt codes
// (n, n); the fp32 kernel's tiling over packed words, without the prefetch
constexpr int KW = 8;  // packed words per k slice: 32 codes

template <int kOps>
__global__ void __launch_bounds__(kThreads)
colgather_matmul_q8_kernel(const int8_t* __restrict__ b1, const float* __restrict__ s1,
                           const int8_t* __restrict__ b2, const float* __restrict__ s2,
                           const int8_t* __restrict__ qt, const int* __restrict__ idx,
                           float* __restrict__ o1, float* __restrict__ o2, int m, int r,
                           int n) {
  __shared__ __align__(16) int A1[KW][BM + kPad];  // b1 slice, transposed
  __shared__ __align__(16) int A2[kOps == 2 ? KW : 1][BM + kPad];
  __shared__ __align__(16) int Bs[KW][BN];         // gathered rows, packed along k

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long a_off = static_cast<long long>(b) * m * r;
  const long long o_off = static_cast<long long>(b) * m * n;
  const int* idx_b = idx + static_cast<long long>(b) * r;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool vec_a = r % 4 == 0, vec_q = n % 4 == 0;

  int acc1[4][8], acc2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc1[i][j] = 0;
      acc2[i][j] = 0;
    }

  for (int k0 = 0; k0 < r; k0 += 4 * KW) {
#pragma unroll
    for (int t = 0; t < (BM * KW) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int rr = e / KW, w = e % KW;
      const int gr = row0 + rr, gc = k0 + 4 * w;
      const long long off = a_off + static_cast<long long>(gr) * r + gc;
      A1[w][rr] = gr < m ? q8::load4(b1 + off, r - gc, vec_a) : 0;
      if constexpr (kOps == 2) A2[w][rr] = gr < m ? q8::load4(b2 + off, r - gc, vec_a) : 0;
    }
    {  // one (word row, 4 columns) block of the gathered rows per thread
      const int w = tid / (BN / 4), c = tid % (BN / 4);
      const int col = col0 + 4 * c;
      int rw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * w + i;
        const int src = k < r ? idx_b[k] : -1;
        rw[i] = (src >= 0 && src < n)
                    ? q8::load4(qt + static_cast<long long>(src) * n + col, n - col, vec_q)
                    : 0;
      }
      *reinterpret_cast<int4*>(&Bs[w][4 * c]) = q8::transpose4(rw);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int4 x1 = *reinterpret_cast<const int4*>(&A1[w][ty * 4]);
      const int4 q0 = *reinterpret_cast<const int4*>(&Bs[w][tx * 4]);
      const int4 q1 = *reinterpret_cast<const int4*>(&Bs[w][64 + tx * 4]);
      const int a1[4] = {x1.x, x1.y, x1.z, x1.w};
      const int qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc1[i][j] = __dp4a(a1[i], qv[j], acc1[i][j]);
      if constexpr (kOps == 2) {
        const int4 x2 = *reinterpret_cast<const int4*>(&A2[w][ty * 4]);
        const int a2[4] = {x2.x, x2.y, x2.z, x2.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc2[i][j] = __dp4a(a2[i], qv[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: one scale per row, float(acc) * sb[row]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= m) continue;
    const long long srow = static_cast<long long>(b) * m + row;
    const float sc1 = s1[srow];
    const float sc2 = kOps == 2 ? s2[srow] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < n) {
        const long long off = o_off + static_cast<long long>(row) * n + col;
        o1[off] = __fmul_rn(__int2float_rn(acc1[i][j]), sc1);
        if constexpr (kOps == 2) o2[off] = __fmul_rn(__int2float_rn(acc2[i][j]), sc2);
      }
    }
  }
}

// bf16 on the tensor cores
namespace tc {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;         // k slice
constexpr int kThreads = 256;  // 8 warps: 2 along M (64 rows) x 4 along N (32 columns)
constexpr int kLdA = BK + 8;   // bf16 row stride of the b tiles
constexpr int kLdB = BN + 8;   // bf16 row stride of the gathered tile
constexpr int kLdO = BN + 8;   // fp32 row stride of a staged output tile

template <int kOps>
struct Slices {
  float a32[2][kOps][BM][BK];  // b slices as they arrive (2-stage ring)
  float b32[2][BK][BN];        // gathered rows of Qt
  __nv_bfloat16 a16[2][kOps][BM][kLdA];
  __nv_bfloat16 b16[2][BK][kLdB];
};

// the slices' memory stages one output tile at a time for the stores
template <int kOps>
union Smem {
  Slices<kOps> s;
  float out[BM][kLdO];
};

template <int W>
__device__ __forceinline__ void copy_piece(void* dst, const float* src, bool ok) {
  if constexpr (W == 4)
    mma::cp_async16(dst, src, ok);
  else
    mma::cp_async4(dst, src, ok);
}

// A thread's pieces of k slice k0: W = 4 (16-byte cp.async) or 1 (4-byte).
// Piece e of each b is row e / (BK / W), column W * (e % (BK / W)); of the
// gathered tile, row e / (BN / W) (the selected row idx[k0 + row] of Qt),
// column W * (e % (BN / W)). The same thread copies a piece and rounds it.
template <int kOps, int W>
__device__ __forceinline__ void copy_slice(Slices<kOps>& sm, int slot, const float* a1,
                                           const float* a2, const float* qt, const int* idx_b,
                                           int m, int r, int n, int row0, int col0, int k0) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e / (BK / W), c = W * (e % (BK / W));
    const bool ok = row0 + row < m && k0 + c < r;
    const long long off = ok ? static_cast<long long>(row0 + row) * r + k0 + c : 0;
    copy_piece<W>(&sm.a32[slot][0][row][c], a1 + off, ok);
    if constexpr (kOps == 2) copy_piece<W>(&sm.a32[slot][1][row][c], a2 + off, ok);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / (BN / W), c = W * (e % (BN / W));
    const int src = k0 + k < r ? idx_b[k0 + k] : -1;
    const bool ok = src >= 0 && src < n && col0 + c < n;
    copy_piece<W>(&sm.b32[slot][k][c], ok ? qt + static_cast<long long>(src) * n + col0 + c : qt,
                  ok);
  }
}

template <int W>
__device__ __forceinline__ void round_piece(__nv_bfloat16* dst, const float* src) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<uint2*>(dst) = make_uint2(mma::pack_bf16(x.x, x.y), mma::pack_bf16(x.z, x.w));
  } else {
    *dst = __float2bfloat16_rn(*src);
  }
}

template <int kOps, int W>
__device__ __forceinline__ void round_slice(Slices<kOps>& sm, int slot) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e / (BK / W), c = W * (e % (BK / W));
#pragma unroll
    for (int op = 0; op < kOps; ++op)
      round_piece<W>(&sm.a16[slot][op][row][c], &sm.a32[slot][op][row][c]);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / (BN / W), c = W * (e % (BN / W));
    round_piece<W>(&sm.b16[slot][k][c], &sm.b32[slot][k][c]);
  }
}

// the dual instance's two accumulator sets take up to 255 registers, one CTA
// per SM; the single one two CTAs per SM (128 registers) with 16-byte
// copies, one with the 4-byte copies' address arithmetic
template <int kOps, int W>
__global__ void __launch_bounds__(kThreads, kOps == 1 && W == 4 ? 2 : 1)
colgather_matmul_bf16_kernel(const float* __restrict__ b1, const float* __restrict__ b2,
                             const float* __restrict__ qt, const int* __restrict__ idx,
                             float* __restrict__ o1, float* __restrict__ o2, int m, int r,
                             int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<kOps>& sm = *reinterpret_cast<Smem<kOps>*>(smem_raw);

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long a_off = static_cast<long long>(b) * m * r;
  const float* a1 = b1 + a_off;
  const float* a2 = kOps == 2 ? b2 + a_off : nullptr;
  const int* idx_b = idx + static_cast<long long>(b) * r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 64 x 32 tile
  const int g8 = lane >> 2, t = lane & 3;

  float acc[kOps][4][4][4];
#pragma unroll
  for (int op = 0; op < kOps; ++op)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[op][i][j][e] = 0.f;

  const int slices = (r + BK - 1) / BK;
  if (slices > 0) copy_slice<kOps, W>(sm.s, 0, a1, a2, qt, idx_b, m, r, n, row0, col0, 0);
  mma::cp_async_commit();
  for (int kt = 0; kt < slices; ++kt) {
    const int slot = kt & 1;
    mma::cp_async_wait<0>();  // this thread's pieces of slice kt
    if (kt + 1 < slices)
      copy_slice<kOps, W>(sm.s, slot ^ 1, a1, a2, qt, idx_b, m, r, n, row0, col0, (kt + 1) * BK);
    mma::cp_async_commit();
    round_slice<kOps, W>(sm.s, slot);
    __syncthreads();  // the rounded slice is complete; buffer slot ^ 1 is free again
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // matrix i = lane / 8 of ldmatrix.trans: k 8 (i % 2) + lane % 8 of
      // the step, columns 8 (i / 2) of the pair's 16: registers {b0, b1} of
      // column tile 2 np, then 2 np + 1
      unsigned bq[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned q[4];
        mma::ldmatrix_x4_trans(q, &sm.s.b16[slot][ks * 16 + (lane & 15)]
                                           [wn * 32 + np * 16 + (lane >> 4) * 8]);
        bq[2 * np][0] = q[0];
        bq[2 * np][1] = q[1];
        bq[2 * np + 1][0] = q[2];
        bq[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        unsigned af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma::ldmatrix_x4(af[mt], &sm.s.a16[slot][op][wm * 64 + mt * 16 + (lane & 15)]
                                              [ks * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma::mma_bf16(acc[op][mt][nt], af[mt], bq[nt][0], bq[nt][1]);
      }
    }
  }

  // epilogue, one output at a time: the fragments into the staged tile, then
  // a warp to each row of it, 16 bytes a lane
  const long long o_off = static_cast<long long>(b) * m * n;
#pragma unroll
  for (int op = 0; op < kOps; ++op) {
    __syncthreads();  // the products (or the previous output's stores) are done with the memory
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(&sm.out[wm * 64 + mt * 16 + g8 + 8 * hf]
                                            [wn * 32 + nt * 8 + 2 * t]) =
              make_float2(acc[op][mt][nt][2 * hf], acc[op][mt][nt][2 * hf + 1]);
    __syncthreads();
    float* ob = (op == 0 ? o1 : o2) + o_off;
#pragma unroll 4
    for (int i = 0; i < BM * BN / 4 / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int row = e / (BN / 4), c = 4 * (e % (BN / 4));
      const int col = col0 + c;
      if (row0 + row >= m) break;  // the rows of later i are larger still
      const float4 v = *reinterpret_cast<const float4*>(&sm.out[row][c]);
      float* dst = ob + static_cast<long long>(row0 + row) * n + col;
      if (W == 4) {
        if (col < n) *reinterpret_cast<float4*>(dst) = v;
      } else {
        if (col < n) dst[0] = v.x;
        if (col + 1 < n) dst[1] = v.y;
        if (col + 2 < n) dst[2] = v.z;
        if (col + 3 < n) dst[3] = v.w;
      }
    }
  }
}

}  // namespace tc

}  // namespace

namespace {

dim3 gather_grid(int batch, int m, int n) {
  return dim3((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
}

template <int kOps>
int gather(const float* b1, const float* b2, const float* qt, const int* idx, float* o1,
           float* o2, int batch, int m, int r, int n, void* stream) {
  if (batch > 0 && m > 0 && n > 0)
    colgather_matmul_kernel<kOps>
        <<<gather_grid(batch, m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            b1, b2, qt, idx, o1, o2, m, r, n);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// 16-byte copies and stores need r % 4 == 0, n % 4 == 0 and every operand
// and output on 16 bytes; otherwise the same kernel moves 4-byte pieces
template <int kOps>
int gather_bf16(const float* b1, const float* b2, const float* qt, const int* idx, float* o1,
                float* o2, int batch, int m, int r, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto launch = [&](auto kernel) {
    const size_t smem = sizeof(tc::Smem<kOps>);
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    kernel<<<dim3((n + tc::BN - 1) / tc::BN, (m + tc::BM - 1) / tc::BM, batch), tc::kThreads,
             smem, static_cast<cudaStream_t>(stream)>>>(b1, b2, qt, idx, o1, o2, m, r, n);
    return static_cast<int>(cudaGetLastError());
  };
  const bool wide = r % 4 == 0 && n % 4 == 0 && aligned(b1, 16) && aligned(qt, 16) &&
                    aligned(o1, 16) && (kOps == 1 || (aligned(b2, 16) && aligned(o2, 16)));
  return wide ? launch(tc::colgather_matmul_bf16_kernel<kOps, 4>)
              : launch(tc::colgather_matmul_bf16_kernel<kOps, 1>);
}

template <int kOps>
int gather_q8(const int8_t* b1, const float* s1, const int8_t* b2, const float* s2,
              const int8_t* qt, const int* idx, float* o1, float* o2, int batch, int m, int r,
              int n, void* stream) {
  if (batch > 0 && m > 0 && n > 0)
    colgather_matmul_q8_kernel<kOps>
        <<<gather_grid(batch, m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            b1, s1, b2, s2, qt, idx, o1, o2, m, r, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_colgather_matmul_dual(const float* b1, const float* b2, const float* qt,
                                           const int* idx, float* o1, float* o2, int batch,
                                           int m, int r, int n, void* stream) {
  return gather<2>(b1, b2, qt, idx, o1, o2, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul(const float* b, const float* qt, const int* idx,
                                      float* o, int batch, int m, int r, int n,
                                      void* stream) {
  return gather<1>(b, nullptr, qt, idx, o, nullptr, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul_dual_bf16(const float* b1, const float* b2,
                                                const float* qt, const int* idx, float* o1,
                                                float* o2, int batch, int m, int r, int n,
                                                void* stream) {
  return gather_bf16<2>(b1, b2, qt, idx, o1, o2, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul_bf16(const float* b, const float* qt, const int* idx,
                                           float* o, int batch, int m, int r, int n,
                                           void* stream) {
  return gather_bf16<1>(b, nullptr, qt, idx, o, nullptr, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul_dual_q8(const int8_t* b1, const float* s1,
                                              const int8_t* b2, const float* s2,
                                              const int8_t* qt, const int* idx, float* o1,
                                              float* o2, int batch, int m, int r, int n,
                                              void* stream) {
  return gather_q8<2>(b1, s1, b2, s2, qt, idx, o1, o2, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul_q8(const int8_t* b, const float* sb, const int8_t* qt,
                                         const int* idx, float* o, int batch, int m, int r,
                                         int n, void* stream) {
  return gather_q8<1>(b, sb, nullptr, nullptr, qt, idx, o, nullptr, batch, m, r, n, stream);
}
