// Column-gather back-projection for Hopper, one operand or two:
//   o1 = b1 @ Qt[idx, :]             (colgather_matmul)
//   o1, o2 = b1, b2 @ Qt[idx, :]     (colgather_matmul_dual)
// with b1, b2 (batch, m, r), Qt = Q^T (n, n) contiguous, idx (batch, r)
// int32 per layer, in three precisions. Replaces
// repro/kernels/colgather_matmul.py::_kernel and ::_kernel_dual (fp32, and
// bf16 with cast=bfloat16) and ::_kernel_q8 and ::_kernel_dual_q8 (int8);
// each precision is one template instantiated for one and for two operands.
// Row k of the gathered factor is Qt[idx[k], :]; each CTA reads idx itself
// and copies the selected rows of its column tile straight from Qt, so the
// gathered (r, n) factor never exists in device memory. An index outside
// [0, n) gathers a zero row (the copy reads nothing), so a bad index cannot
// read outside Qt. Ragged m, n and r are masked.
//
// fp32. The function: IEEE fp32 FMA, k ascending, so every launch gives the
// same bits. Bound: fp32 FMA rate (2*m*n*r flops per operand and layer
// against the (m, n) fp32 outputs: at r = 128, 64 flops per byte written).
// Design: dct_project.cu's pipelined SIMT GEMM with a gathered B, over
// stacked rows. A CTA of 256 threads owns a GEMM tile of 128 rows x 128
// columns: 128 rows of b (single) or the same 64 rows of b1 and of b2
// (dual), so the dual takes both products from each gathered slice with
// one set of accumulators. Each thread keeps an 8 x 8 register tile: rows
// in two groups of 4, 64 apart (in the dual 4 rows of b1 and the same 4 of
// b2), columns in two groups of 4, 64 apart. The stacked rows of b and the
// gathered rows of Qt (row k of the B tile copied from Qt[idx[k], col0:])
// arrive by cp.async in 16-deep k slices into a 2-stage ring (16-byte
// pieces; 4-byte ones where r % 4, n % 4 or an address forbids 16; a
// source size of 0 zero-fills an index outside [0, n) and k past r); each
// thread transposes the b pieces it copied itself into a double-buffered
// k-major tile (rows padded to 132 floats), so one barrier per slice
// suffices. Per k step a thread reads 4 float4s for 64 FMAs, each warp
// read covering 64 or 128 contiguous bytes. The outputs are stored from the
// registers as float4s, a warp writing 4 rows x 128 bytes at a time. 128
// registers a thread and 49 KB of shared memory: two CTAs per SM, so one
// tile's prologue and stores run under the other's products (r = 128 is
// only 8 slices a tile). On an H100 (scripts/colgather_tiles_probe.py)
// 128 x 256 tiles with 8 x 16 a thread at one CTA per SM, 128-thread CTAs
// of 8 x 16 a thread at two per SM, and 8- or 32-deep slices were slower.
// The single instance's output equals the dual's first bit for bit (each
// output is the same chain of FMAs).
//
// int8 takes Qt quantized per row (codes qt (n, n)) and each b quantized
// per row after the selected rows' scales were folded into it (codes b
// (batch, m, r), scales sb (batch, m)); the wrapper quantizes (two launches
// of quant_ef.cu). The function: exact int32 sums (|sum| <= 127^2 * r <
// 2^31), written out as __fmul_rn(float(acc), sb[i]): the plain version's
// result bit for bit. Bound: bytes (the fp32 outputs). Design: mma.sync
// m16n8k32 (int8 in, int32 accumulators), as the int8 dct_project, over
// the same stacked rows as fp32: a CTA of 8 warps owns 128 stacked rows x
// 128 columns (a warp 64 x 32: 4 x 4 mma tiles; in the dual warps 0-3
// take b1's rows, warps 4-7 b2's), one accumulator set, 2 CTAs per SM. The codes of b and the gathered rows of Qt's codes arrive by cp.async
// in 128-deep k slices into a 2-stage ring. The gathered rows arrive
// k-major (row k holds Qt[idx[k], cols]), but an m16n8k32 B fragment holds
// 4 consecutive k of one column, and ldmatrix.trans moves 16-bit elements
// only. So each slice is transposed in shared memory into column-major
// rows (column c: its 128 k codes, row stride 144 bytes) that plain
// ldmatrix reads as the int8 dct_project reads Q^T's codes. Warp w
// transposes k rows 16w .. 16w + 15, lane l the columns 4l .. 4l + 3: it
// reads 16 words (one per k row; a warp reads 128 contiguous bytes of a row:
// no conflict), packs them by 4x4 byte transposes (q8::transpose4) into 16
// k codes per column, and stores the 4 columns as 16-byte words in the
// order j = (i + l / 2) % 4 (i = 0..3): the 16-byte store of lane l lands
// in bank quad (4l + j + w) % 8, and the 8 lanes of each quarter-warp hit 8
// distinct quads. Rows of 144 bytes keep the ldmatrix reads of A and B
// conflict-free. The epilogue scales each stacked row, stages the
// 128 x 128 fp32 tile in shared memory (rows padded to 132 floats) and
// writes it a warp to each 512-byte row, 16 bytes a lane (4-byte stores
// where n % 4 or an address forbids). An r that is not a multiple of 32 is
// padded with zero codes.
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
// col0 + 128), copied from that row's address) arrive by cp.async in 32-deep
// k slices into a 2-stage fp32 ring (16-byte pieces; 4-byte ones where
// r % 4, n % 4 or an address forbids 16), and each thread rounds the pieces
// it copied itself to bf16 (__floats2bfloat162_rn) into a double-buffered
// tile that ldmatrix reads (the gathered rows through ldmatrix.trans), so
// one barrier per slice suffices. A ragged r reads zeros past r. The dual
// instance takes both products from each B fragment it loads: two
// accumulator sets, 128 fp32 registers a thread and 153 KB of shared
// memory, one CTA per SM (the single instance: 64 registers of sums and 101
// KB, two CTAs per SM). The epilogue stages each output's tile in shared
// memory (rows padded against bank conflicts) and writes it as 16-byte
// stores, a warp to each 512-byte row (4-byte stores where n % 4 or an
// address forbids). The tensor cores' fp32 sums are not a sequence of IEEE
// adds, so the outputs differ from the plain version by more than an order
// of fp32 sums would (chip_smoke.py's LOWP_TC_RTOL). The single instance's
// output equals the dual's first bit for bit (the same mma sequence), and a
// relaunch gives the same bits.
#include <cstdint>

#include <cuda_runtime.h>

#include "lowp.cuh"
#include "mma.cuh"

namespace {

// 16-byte (W = 4) or 4-byte (W = 1) cp.async of fp32 pieces
template <int W>
__device__ __forceinline__ void copy_f32(void* dst, const float* src, bool ok) {
  if constexpr (W == 4)
    mma::cp_async16(dst, src, ok);
  else
    mma::cp_async4(dst, src, ok);
}

// fp32 on the SIMT cores
namespace f32 {

constexpr int TM = 8;                  // stacked rows per thread
constexpr int TN = 8;                  // columns per thread
constexpr int TY = 16;                 // thread rows
constexpr int TX = 16;                 // thread columns
constexpr int kThreads = TY * TX;
constexpr int BM = TY * TM;            // stacked rows per CTA
constexpr int BN = TX * TN;            // columns per CTA
constexpr int BK = 16;                 // k slice
constexpr int kMinBlocks = 2;          // CTAs per SM the launch bounds ask for
constexpr int kLdT = BM + 4;           // row stride (floats) of the transposed b tile

struct Smem {
  float a32[2][BM][BK];  // stacked rows of b as they arrive (2-stage ring)
  float at[2][BK][kLdT]; // the same, transposed: k rows of BM stacked rows
  float b[2][BK][BN];    // gathered rows of Qt
};

// A thread's pieces of k slice k0: W = 4 (16-byte cp.async) or 1 (4-byte).
// Stacked row s of the A tile is row row0 + s % (BM / kOps) of b1 (s <
// BM / kOps) or of b2; piece e of it is s = e / (BK / W), column W * (e %
// (BK / W)). Piece e of the gathered tile is row e / (BN / W) (the selected
// row idx[k0 + row] of Qt), column W * (e % (BN / W)). The thread that
// copies a piece of b also transposes it (transpose_slice).
template <int kOps, int W>
__device__ __forceinline__ void copy_slice(Smem& sm, int slot, const float* a1, const float* a2,
                                           const float* qt, const int* idx_b, int m, int r, int n,
                                           int row0, int col0, int k0) {
  constexpr int kRows = BM / kOps;
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / (BK / W), c = W * (e % (BK / W));
    const float* a = kOps == 2 && s >= kRows ? a2 : a1;
    const int row = row0 + s % kRows;
    const bool ok = row < m && k0 + c < r;
    copy_f32<W>(&sm.a32[slot][s][c], ok ? a + static_cast<long long>(row) * r + k0 + c : a1, ok);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / (BN / W), c = W * (e % (BN / W));
    const int src = k0 + k < r ? idx_b[k0 + k] : -1;
    const bool ok = src >= 0 && src < n && col0 + c < n;
    copy_f32<W>(&sm.b[slot][k][c], ok ? qt + static_cast<long long>(src) * n + col0 + c : qt, ok);
  }
}

template <int W>
__device__ __forceinline__ void transpose_slice(Smem& sm, int slot, int buf) {
#pragma unroll
  for (int i = 0; i < BM * BK / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / (BK / W), c = W * (e % (BK / W));
    if constexpr (W == 4) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.a32[slot][s][c]);
      sm.at[buf][c][s] = x.x;
      sm.at[buf][c + 1][s] = x.y;
      sm.at[buf][c + 2][s] = x.z;
      sm.at[buf][c + 3][s] = x.w;
    } else {
      sm.at[buf][c][s] = sm.a32[slot][s][c];
    }
  }
}

// the thread's local (stacked) row i < TM and column j < TN: groups of 4,
// the groups BM / (TM / 4) rows and BN / (TN / 4) columns apart
__device__ __forceinline__ int local_row(int ty, int i) {
  return (BM / (TM / 4)) * (i / 4) + 4 * ty + i % 4;
}
__device__ __forceinline__ int local_col(int tx, int j) {
  return (BN / (TN / 4)) * (j / 4) + 4 * tx + j % 4;
}

template <int kOps, int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
colgather_matmul_kernel(const float* __restrict__ b1, const float* __restrict__ b2,
                        const float* __restrict__ qt, const int* __restrict__ idx,
                        float* __restrict__ o1, float* __restrict__ o2, int m, int r, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  constexpr int kRows = BM / kOps;

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * BN;
  const long long a_off = static_cast<long long>(b) * m * r;
  const float* a1 = b1 + a_off;
  const float* a2 = kOps == 2 ? b2 + a_off : nullptr;
  const int* idx_b = idx + static_cast<long long>(b) * r;
  // a warp is 4 thread rows x 8 thread columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int slices = (r + BK - 1) / BK;
  if (slices > 0) copy_slice<kOps, W>(sm, 0, a1, a2, qt, idx_b, m, r, n, row0, col0, 0);
  mma::cp_async_commit();
  for (int kt = 0; kt < slices; ++kt) {
    const int slot = kt & 1;
    mma::cp_async_wait<0>();  // this thread's pieces of slice kt
    transpose_slice<W>(sm, slot, slot);
    // every piece of slice kt is in place; every thread is done with slice
    // kt - 1, so its ring slot and the other transposed buffer are free
    __syncthreads();
    if (kt + 1 < slices)
      copy_slice<kOps, W>(sm, slot ^ 1, a1, a2, qt, idx_b, m, r, n, row0, col0, (kt + 1) * BK);
    mma::cp_async_commit();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.at[slot][k][local_row(ty, 4 * h)]);
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

  // epilogue: each stacked row to its operand's output, float4 stores
  const long long o_off = static_cast<long long>(b) * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = local_row(ty, i);
    const int row = row0 + s % kRows;
    if (row >= m) continue;
    float* orow = (kOps == 2 && s >= kRows ? o2 : o1) + o_off + static_cast<long long>(row) * n;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = col0 + local_col(tx, 4 * h);
      if (W == 4) {
        if (col < n)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) orow[col + j] = acc[i][4 * h + j];
      }
    }
  }
}

}  // namespace f32

// int8 on the tensor cores
namespace i8 {

constexpr int BM = 128;        // stacked rows per CTA
constexpr int BN = 128;        // columns per CTA
constexpr int BK = 128;        // k slice in codes (four m16n8k32 steps)
constexpr int kThreads = 256;  // 8 warps: 2 along M (64 rows) x 4 along N (32 columns)
constexpr int kLd = BK + 16;   // row stride (bytes) of the b tile and the transposed gathered tile
constexpr int kLdO = BN + 4;   // fp32 row stride of the staged output tile

struct Slices {
  int8_t a[2][BM][kLd];  // codes of the stacked rows of b, k along a row (2-stage ring)
  int8_t g[2][BK][BN];   // gathered rows of Qt's codes as they arrive: k rows
  int8_t bt[BN][kLd];    // the current slice of g transposed: columns, k along a row
};

// the slices' memory stages the output tile for the stores
union Smem {
  Slices s;
  float out[BM][kLdO];
};

// A piece of W codes: by cp.async (W = 16, 4), or (W = 1, for an r, an n
// or an address that allows neither) as byte loads packed into one shared
// store per 4 codes; codes at offsets >= limit read as 0
template <int W>
__device__ __forceinline__ void copy_codes(int8_t* dst, const int8_t* src, bool ok, int limit) {
  if constexpr (W == 16)
    mma::cp_async16(dst, src, ok);
  else if constexpr (W == 4)
    mma::cp_async4(dst, src, ok);
  else
    *reinterpret_cast<int*>(dst) = ok ? q8::load4(src, limit, false) : 0;
}

// A thread's pieces of k slice k0, laid out as fp32's copy_slice: stacked
// rows of b, then k rows of the gathered tile; pieces of 16 or 4 codes
template <int kOps, int W>
__device__ __forceinline__ void copy_slice(Slices& sm, int slot, const int8_t* a1,
                                           const int8_t* a2, const int8_t* qt, const int* idx_b,
                                           int m, int r, int n, int row0, int col0, int k0) {
  constexpr int kRows = BM / kOps;
  constexpr int kPiece = W == 16 ? 16 : 4;
#pragma unroll
  for (int i = 0; i < BM * BK / kPiece / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / (BK / kPiece), c = kPiece * (e % (BK / kPiece));
    const int8_t* a = kOps == 2 && s >= kRows ? a2 : a1;
    const int row = row0 + s % kRows;
    const bool ok = row < m && k0 + c < r;
    copy_codes<W>(&sm.a[slot][s][c], ok ? a + static_cast<long long>(row) * r + k0 + c : a1, ok,
                  r - k0 - c);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / kPiece / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / (BN / kPiece), c = kPiece * (e % (BN / kPiece));
    const int src = k0 + k < r ? idx_b[k0 + k] : -1;
    const bool ok = src >= 0 && src < n && col0 + c < n;
    copy_codes<W>(&sm.g[slot][k][c], ok ? qt + static_cast<long long>(src) * n + col0 + c : qt,
                  ok, n - col0 - c);
  }
}

__device__ __forceinline__ int word(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// g[slot] (k rows) -> bt (columns): warp w takes k rows 16w .. 16w + 15,
// lane l columns 4l .. 4l + 3 (the source note's conflict-free order)
__device__ __forceinline__ void transpose_slice(Slices& sm, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int rw[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) rw[i] = *reinterpret_cast<const int*>(&sm.g[slot][16 * warp + i][4 * lane]);
  int4 t[4];  // t[q] word j: column 4l + j at k 16w + 4q .. 16w + 4q + 3
#pragma unroll
  for (int q = 0; q < 4; ++q) t[q] = q8::transpose4(&rw[4 * q]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + (lane >> 1)) & 3;
    *reinterpret_cast<int4*>(&sm.bt[4 * lane + j][16 * warp]) =
        make_int4(word(t[0], j), word(t[1], j), word(t[2], j), word(t[3], j));
  }
}

// two CTAs per SM with the cp.async copies, one with the byte loads' address
// arithmetic
template <int kOps, int W>
__global__ void __launch_bounds__(kThreads, W == 1 ? 1 : 2)
colgather_matmul_q8_kernel(const int8_t* __restrict__ b1, const float* __restrict__ s1,
                           const int8_t* __restrict__ b2, const float* __restrict__ s2,
                           const int8_t* __restrict__ qt, const int* __restrict__ idx,
                           float* __restrict__ o1, float* __restrict__ o2, int m, int r,
                           int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  constexpr int kRows = BM / kOps;

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * BN;
  const long long a_off = static_cast<long long>(b) * m * r;
  const int8_t* a1 = b1 + a_off;
  const int8_t* a2 = kOps == 2 ? b2 + a_off : nullptr;
  const int* idx_b = idx + static_cast<long long>(b) * r;
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

  const int slices = (r + BK - 1) / BK;
  if (slices > 0) copy_slice<kOps, W>(sm.s, 0, a1, a2, qt, idx_b, m, r, n, row0, col0, 0);
  mma::cp_async_commit();
  for (int kt = 0; kt < slices; ++kt) {
    const int slot = kt & 1;
    mma::cp_async_wait<0>();  // this thread's pieces of slice kt
    // everyone's pieces of slice kt; every thread is done with slice kt - 1
    // (its ring slot and bt)
    __syncthreads();
    if (kt + 1 < slices)
      copy_slice<kOps, W>(sm.s, slot ^ 1, a1, a2, qt, idx_b, m, r, n, row0, col0, (kt + 1) * BK);
    mma::cp_async_commit();
    transpose_slice(sm.s, slot);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned af[4][4], bq[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        mma::ldmatrix_x4(af[mt], &sm.s.a[slot][wm * 64 + mt * 16 + (lane & 15)]
                                          [ks * 32 + (lane >> 4) * 16]);
      // matrix i = lane / 8: columns 8 (i / 2) + lane % 8 of the pair's 16,
      // k bytes 16 (i % 2): registers {b0, b1} of column tile 2 np, then 2 np + 1
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned q[4];
        mma::ldmatrix_x4(q, &sm.s.bt[wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)]
                                    [ks * 32 + ((lane >> 3) & 1) * 16]);
        bq[2 * np][0] = q[0];
        bq[2 * np][1] = q[1];
        bq[2 * np + 1][0] = q[2];
        bq[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma::mma_s8(acc[mt][nt], af[mt], bq[nt][0], bq[nt][1]);
    }
  }

  // epilogue: float(acc) * sb[row] into the staged tile, then a warp to each
  // row of it, 16 bytes a lane
  const long long s_off = static_cast<long long>(b) * m;
  __syncthreads();  // the products are done with the slices' memory
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = wm * 64 + mt * 16 + g8 + 8 * hf;
      const int row = row0 + s % kRows;
      const float sc = row < m ? (kOps == 2 && s >= kRows ? s2 : s1)[s_off + row] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(&sm.out[s][wn * 32 + nt * 8 + 2 * t]) =
            make_float2(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hf]), sc),
                        __fmul_rn(__int2float_rn(acc[mt][nt][2 * hf + 1]), sc));
    }
  __syncthreads();
  const long long o_off = s_off * n;
#pragma unroll 4
  for (int i = 0; i < BM * BN / 4 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / (BN / 4), c = 4 * (e % (BN / 4));
    const int row = row0 + s % kRows, col = col0 + c;
    if (row >= m) continue;
    const float4 v = *reinterpret_cast<const float4*>(&sm.out[s][c]);
    float* dst = (kOps == 2 && s >= kRows ? o2 : o1) + o_off + static_cast<long long>(row) * n + col;
    if (W >= 4) {
      if (col < n) *reinterpret_cast<float4*>(dst) = v;
    } else {
      if (col < n) dst[0] = v.x;
      if (col + 1 < n) dst[1] = v.y;
      if (col + 2 < n) dst[2] = v.z;
      if (col + 3 < n) dst[3] = v.w;
    }
  }
}

}  // namespace i8

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
    copy_f32<W>(&sm.a32[slot][0][row][c], a1 + off, ok);
    if constexpr (kOps == 2) copy_f32<W>(&sm.a32[slot][1][row][c], a2 + off, ok);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / W / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = e / (BN / W), c = W * (e % (BN / W));
    const int src = k0 + k < r ? idx_b[k0 + k] : -1;
    const bool ok = src >= 0 && src < n && col0 + c < n;
    copy_f32<W>(&sm.b32[slot][k][c], ok ? qt + static_cast<long long>(src) * n + col0 + c : qt,
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

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// a kernel with more than 48 KB of dynamic shared memory on the (column
// tiles, row tiles, layers) grid
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int threads, size_t smem, int rows, int cols, int batch, int m,
                 int n, void* stream, Args... args) {
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3((n + cols - 1) / cols, (m + rows - 1) / rows, batch), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies and stores need r % 4 == 0, n % 4 == 0 and every operand
// and output on 16 bytes; otherwise the same kernel moves 4-byte pieces
template <int kOps>
bool wide_f32(const float* b1, const float* b2, const float* qt, const float* o1,
              const float* o2, int r, int n) {
  return r % 4 == 0 && n % 4 == 0 && aligned(b1, 16) && aligned(qt, 16) && aligned(o1, 16) &&
         (kOps == 1 || (aligned(b2, 16) && aligned(o2, 16)));
}

template <int kOps>
int gather(const float* b1, const float* b2, const float* qt, const int* idx, float* o1,
           float* o2, int batch, int m, int r, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto launch = [&](auto kernel) {
    return launch_tiles(kernel, f32::kThreads, sizeof(f32::Smem), f32::BM / kOps, f32::BN, batch,
                        m, n, stream, b1, b2, qt, idx, o1, o2, m, r, n);
  };
  return wide_f32<kOps>(b1, b2, qt, o1, o2, r, n)
             ? launch(f32::colgather_matmul_kernel<kOps, 4>)
             : launch(f32::colgather_matmul_kernel<kOps, 1>);
}

template <int kOps>
int gather_bf16(const float* b1, const float* b2, const float* qt, const int* idx, float* o1,
                float* o2, int batch, int m, int r, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto launch = [&](auto kernel) {
    return launch_tiles(kernel, tc::kThreads, sizeof(tc::Smem<kOps>), tc::BM, tc::BN, batch, m, n,
                        stream, b1, b2, qt, idx, o1, o2, m, r, n);
  };
  return wide_f32<kOps>(b1, b2, qt, o1, o2, r, n)
             ? launch(tc::colgather_matmul_bf16_kernel<kOps, 4>)
             : launch(tc::colgather_matmul_bf16_kernel<kOps, 1>);
}

// int8: 16-byte copies where r % 16 == 0 and n % 16 == 0 with the codes on
// 16 bytes, 4-byte ones where r % 4 == 0 and n % 4 == 0 on 4, else byte
// loads; the 16-byte stores need n % 4 == 0 and the outputs on 16 bytes
template <int kOps>
int gather_q8(const int8_t* b1, const float* s1, const int8_t* b2, const float* s2,
              const int8_t* qt, const int* idx, float* o1, float* o2, int batch, int m, int r,
              int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto launch = [&](auto kernel) {
    return launch_tiles(kernel, i8::kThreads, sizeof(i8::Smem), i8::BM / kOps, i8::BN, batch, m,
                        n, stream, b1, s1, b2, s2, qt, idx, o1, o2, m, r, n);
  };
  const auto codes_on = [&](int bytes) {
    return aligned(b1, bytes) && aligned(qt, bytes) && (kOps == 1 || aligned(b2, bytes));
  };
  const bool stores = aligned(o1, 16) && (kOps == 1 || aligned(o2, 16));
  if (stores && r % 16 == 0 && n % 16 == 0 && codes_on(16))
    return launch(i8::colgather_matmul_q8_kernel<kOps, 16>);
  if (stores && r % 4 == 0 && n % 4 == 0 && codes_on(4))
    return launch(i8::colgather_matmul_q8_kernel<kOps, 4>);
  return launch(i8::colgather_matmul_q8_kernel<kOps, 1>);
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
