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
// ns_gram replaces the TPU kernel's sweep over X's column blocks, a
// sequential grid axis with the (r, r) sum resident in VMEM. Bound: the
// fp32 FMA rate (r (r + 1) m flops for the distinct entries of A against
// 4 r m bytes of X). Trion's calls have A of 128 x 128 per layer and
// m = 1024 or 2816, so the long axis is m, and a CTA per output tile (24 x
// 10 at r = 128) does not fill 132 SMs. Design: a split-K SIMT GEMM and a
// fixed-order sum, two kernels behind one C entry point.
//
// * Split. m is cut into S ranges of `width` columns (a multiple of the
//   16-deep k slice; the wrapper chooses both: 16 ranges at Trion's m, 384
//   CTAs for 24 layers, at most 3 on an SM). A CTA owns one (layer, range)
//   pair and one 128 x 128 macro tile of A on or above the diagonal: at
//   r <= 128 all of A, so X is read once.
// * Symmetry. A macro tile is cut into 32 x 32 blocks; only the blocks on
//   or above the diagonal are computed (10 of 16 at r = 128), two to a
//   warp: a warp's 32 x 64 region is one row of blocks by two column
//   blocks (pairs within a row; the rows' odd blocks out, all in the last
//   column, as a row of their transposes). So a CTA has as many warps as
//   the macro tile has pairs: 5 at r = 128 (1-3 for r <= 96; 8 for a tile
//   off the diagonal, when r > 128), and no warp idles at r <= 128. Each
//   block off the diagonal is written to A[i][j] and A[j][i]; inside a
//   block on the diagonal A[p][q] and A[q][p] come from the same FMAs
//   (fmaf(x_p, x_q, s) == fmaf(x_q, x_p, s)) and the same sum, so A is
//   exactly symmetric.
// * Loads. X's rows arrive by cp.async (16-byte pieces; 4-byte ones where
//   m % 4 or X's address forbids 16) into a 4-stage ring of 16-deep k
//   slices; each thread transposes the pieces it copied into a
//   double-buffered k-major tile, so one barrier per slice suffices (the
//   design of dct_project.cu's fp32 kernel). A thread owns an 8 x 8
//   register tile (rows in two groups of 4, 16 apart; columns 4 in each of
//   its warp's two blocks): 4 float4 shared reads per 64 FMAs, each
//   covering 64 or 128 contiguous bytes of a warp. 49 KB of shared memory
//   and at most 128 registers: 3 CTAs per SM at r = 128.
// * Fixed-order sum. Each CTA writes its partial sums (IEEE fp32 FMA, k
//   ascending) from registers to its entry of a workspace the wrapper
//   allocates (S x 40 KB per layer at r = 128, in L2); the second kernel
//   sums each entry over ranges 0, 1, ..., S - 1 in that order and writes
//   A. No atomics: the same bits on every launch. Columns past m and rows
//   past r load as zeros, which add nothing to A (the TPU kernel pads the
//   columns with zeros too). Why not one launch: summing a layer's ranges
//   inside a thread-block cluster of 16 through distributed shared memory
//   (no workspace) measured 1.39 ms per Trion step against this 1.11 on an
//   H100 80GB HBM3 at 700 W (scripts/ns_gram_probe.py): the clusters were
//   not spread evenly over the SMs, so the slowest CTA's k loop ran 1.3x
//   the median, and the two cluster barriers waited ~4 us a call.
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
#include <cstdint>

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

template <int W>
__device__ __forceinline__ void copy_piece(float* dst, const float* src, bool ok) {
  if constexpr (W == 4)
    mma::cp_async16(dst, src, ok);
  else
    mma::cp_async4(dst, src, ok);
}

// ---- gram -----------------------------------------------------------------
namespace gram {

constexpr int BB = 32;          // a block of A: BB x BB entries
constexpr int kMacro = 4;       // blocks per side of a macro tile (128 rows)
constexpr int BK = 16;          // k slice: columns of X
constexpr int kStages = 4;      // slices in flight
constexpr int kPad = 4;         // keeps the transposed rows on 16 bytes
constexpr int kMinBlocks = 3;   // CTAs per SM the launch bounds ask for, r <= 128
constexpr int kMaxSplits = 64;  // ranges of m
constexpr int kSumThreads = 256;

// rows of X a CTA holds -> its warps: one per pair of blocks of its macro tile
// (r <= 128: rows = 32 * ceil(r / 32), one macro tile; r > 128: the rows of
// two macro tiles, 8 pairs off the diagonal)
template <int kRows>
constexpr int kWarpsOf =
    kRows == 32 ? 1 : kRows == 64 ? 2 : kRows == 96 ? 3 : kRows == 128 ? 5 : 8;

template <int kRows>
struct Ring {
  float raw[kStages][kRows][BK];   // X's slices as they arrive: rows of X
  float xt[2][BK][kRows + kPad];   // the same, transposed: k rows
};

// a warp's partial sums: its 32 x 64 region, row-major; a CTA's are the
// workspace's (layer, macro tile, range) entry
constexpr int kPartFloats = BB * 2 * BB;

// A warp's two blocks: row block rb by column blocks cb0 and cb1, as block
// indices into the CTA's rows of X; cb1 < 0: one block; rb < 0: no blocks.
struct Pair {
  int rb, cb0, cb1;
};

// the blocks on or above the diagonal of a macro tile of tm x tm blocks
__device__ __forceinline__ Pair diagonal_pair(int w, int tm) {
  switch (tm) {
    case 1:
      if (w == 0) return {0, 0, -1};
      break;
    case 2:
      if (w == 0) return {0, 0, 1};
      if (w == 1) return {1, 1, -1};
      break;
    case 3:  // (0,2) as its transpose (2,0)
      if (w < 3) return w == 2 ? Pair{2, 0, 2} : Pair{w, w, w + 1};
      break;
    default:  // (1,3) as its transpose (3,1)
      if (w == 0) return {0, 0, 1};
      if (w == 1) return {0, 2, 3};
      if (w == 2) return {1, 1, 2};
      if (w == 3) return {2, 2, 3};
      if (w == 4) return {3, 1, 3};
  }
  return {-1, -1, -1};
}

// a macro tile off the diagonal: 4 row blocks (the CTA's first 128 rows) by
// tj column blocks (its rows 128..), two to a warp
__device__ __forceinline__ Pair off_diagonal_pair(int w, int tj) {
  const int c = 2 * (w & 1);
  if (c >= tj) return {-1, -1, -1};
  return {w >> 1, kMacro + c, c + 1 < tj ? kMacro + c + 1 : -1};
}

// The macro tile (ti, tj), ti <= tj, of A counted row by row as blockIdx.y
// counts them, and warp w's blocks in it.
struct Tile {
  int ti, tj, blocks;
  __device__ __forceinline__ Tile(int r, int index) : blocks((r + BB - 1) / BB) {
    const int tiles = (blocks + kMacro - 1) / kMacro;
    ti = 0;
    while (index >= tiles - ti) {
      index -= tiles - ti;
      ++ti;
    }
    tj = ti + index;
  }
  __device__ __forceinline__ Pair pair(int w) const {
    return ti == tj ? diagonal_pair(w, min(kMacro, blocks - kMacro * ti))
                    : off_diagonal_pair(w, min(kMacro, blocks - kMacro * tj));
  }
  // the CTA's block sb -> block of A
  __device__ __forceinline__ int block(int sb) const {
    return sb < kMacro ? kMacro * ti + sb : kMacro * tj + sb - kMacro;
  }
  // global row of X held as the CTA's row sr; -1: not held
  template <int kRows>
  __device__ __forceinline__ int x_row(int sr) const {
    if (kRows <= kMacro * BB) return sr;
    if (sr < kMacro * BB) return ti * kMacro * BB + sr;
    return ti == tj ? -1 : tj * kMacro * BB + sr - kMacro * BB;
  }
};

// A thread's pieces of the k slice at column k0 (< k_end, this range's
// end): W = 4 (16-byte cp.async) or 1 (4-byte). Piece e is row e / (BK /
// W), column W * (e % (BK / W)). The thread that copies a piece also
// transposes it (transpose_slice).
template <int kRows, int W>
__device__ __forceinline__ void copy_slice(Ring<kRows>& rg, int slot, const Tile& tile,
                                           const float* xb, int r, int m, int k0, int k_end) {
  constexpr int kPieces = kRows * BK / W, kThreads = 32 * kWarpsOf<kRows>;
#pragma unroll
  for (int i = 0; i < (kPieces + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int sr = e / (BK / W), c = W * (e % (BK / W));
    const int row = tile.x_row<kRows>(sr);
    if (e >= kPieces || row < 0) continue;
    const bool ok = row < r && k0 + c < k_end;
    const float* src = ok ? xb + static_cast<long long>(row) * m + k0 + c : xb;
    copy_piece<W>(&rg.raw[slot][sr][c], src, ok);
  }
}

template <int kRows, int W>
__device__ __forceinline__ void transpose_slice(Ring<kRows>& rg, int slot, int buf,
                                                const Tile& tile) {
  constexpr int kPieces = kRows * BK / W, kThreads = 32 * kWarpsOf<kRows>;
#pragma unroll
  for (int i = 0; i < (kPieces + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int sr = e / (BK / W), c = W * (e % (BK / W));
    if (e >= kPieces || tile.x_row<kRows>(sr) < 0) continue;
    if constexpr (W == 4) {
      const float4 v = *reinterpret_cast<const float4*>(&rg.raw[slot][sr][c]);
      rg.xt[buf][c][sr] = v.x;
      rg.xt[buf][c + 1][sr] = v.y;
      rg.xt[buf][c + 2][sr] = v.z;
      rg.xt[buf][c + 3][sr] = v.w;
    } else {
      rg.xt[buf][c][sr] = rg.raw[slot][sr][c];
    }
  }
}

// The partial sums of one range of m: grid (S ranges, macro tiles on or
// above the diagonal, layers); writes the workspace entry ((layer, tile),
// range). r <= 128: 3 CTAs per SM (at most 128 registers a thread).
template <int kRows, int W>
__global__ void __launch_bounds__(32 * kWarpsOf<kRows>, kRows <= kMacro * BB ? kMinBlocks : 2)
ns_gram_kernel(const float* __restrict__ x, float* __restrict__ ws, int r, int m, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring<kRows>& rg = *reinterpret_cast<Ring<kRows>*>(smem_raw);

  const Tile tile(r, blockIdx.y);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Pair mine = tile.pair(warp);
  const int b = blockIdx.z;
  const float* xb = x + static_cast<long long>(b) * r * m;
  const int k_begin = blockIdx.x * width;
  const int k_end = min(m, k_begin + width);
  const int slices = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // a warp is 4 thread rows x 8 thread columns: rows ra + {0..3, 16..19},
  // columns ca + {0..3} of block cb0 and cb + {0..3} of block cb1
  const int ty = lane >> 3, tx = lane & 7;
  const int ra = mine.rb * BB + 4 * ty;
  const int ca = mine.cb0 * BB + 4 * tx;
  const int cb = (mine.cb1 >= 0 ? mine.cb1 : mine.cb0) * BB + 4 * tx;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < slices) copy_slice<kRows, W>(rg, st, tile, xb, r, m, k_begin + st * BK, k_end);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    const int buf = kt & 1;
    mma::cp_async_wait<kStages - 2>();  // this thread's pieces of slice kt
    transpose_slice<kRows, W>(rg, kt % kStages, buf, tile);
    // every piece of slice kt is in place; every thread is done with slice
    // kt - 1, so its ring slot and transposed buffer are free
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < slices)
      copy_slice<kRows, W>(rg, next % kStages, tile, xb, r, m, k_begin + next * BK, k_end);
    mma::cp_async_commit();
    if (mine.rb < 0) continue;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float* xk = rg.xt[buf][k];
      const float4 a0 = *reinterpret_cast<const float4*>(xk + ra);
      const float4 a1 = *reinterpret_cast<const float4*>(xk + ra + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(xk + ca);
      const float4 b1 = *reinterpret_cast<const float4*>(xk + cb);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      // rows in order, the columns of odd rows backwards (consecutive FMAs
      // share an operand at the turn); each entry's k order is ascending
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = (i & 1) ? 7 - jj : jj;
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
  }

  if (mine.rb < 0) return;
  float* pw = ws + ((static_cast<long long>(b) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                       kWarpsOf<kRows> * kPartFloats +
              warp * kPartFloats;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 16 * (i / 4) + 4 * ty + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(&pw[row * 2 * BB + h * BB + 4 * tx]) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

// The fixed-order sum: grid (chunks of a tile's partials, macro tiles,
// layers). Each thread sums one float4 of the tile's partials over ranges
// 0, 1, ..., S - 1 in that order and writes the entries (and, off the
// diagonal, their transposes).
template <int kRows>
__global__ void __launch_bounds__(kSumThreads)
ns_gram_sum_kernel(const float* __restrict__ ws, float* __restrict__ gram, int r, int splits,
                   bool vec_out) {
  constexpr int kChunks = kWarpsOf<kRows> * kPartFloats / 4;
  const int c = blockIdx.x * kSumThreads + threadIdx.x;
  if (c >= kChunks) return;
  const Tile tile(r, blockIdx.y);
  const int w = c / (kPartFloats / 4), e = 4 * (c % (kPartFloats / 4));
  const int row = e / (2 * BB), col = e % (2 * BB);
  const Pair pr = tile.pair(w);
  const int cbk = col < BB ? pr.cb0 : pr.cb1;
  if (pr.rb < 0 || cbk < 0) return;
  const int gi = tile.block(pr.rb), gj = tile.block(cbk);
  const int p = gi * BB + row, q = gj * BB + col % BB;
  if (p >= r || q >= r) return;

  const int b = blockIdx.z;
  const float4* src = reinterpret_cast<const float4*>(ws) +
                      (static_cast<long long>(b) * gridDim.y + blockIdx.y) * splits * kChunks + c;
  float4 v = src[0];
  // eight ranges' partials are loaded before their adds
  for (int s0 = 1; s0 < splits; s0 += 8) {
    float4 u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s0 + j < splits) u[j] = src[static_cast<long long>(s0 + j) * kChunks];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s0 + j < splits)
        v = make_float4(__fadd_rn(v.x, u[j].x), __fadd_rn(v.y, u[j].y), __fadd_rn(v.z, u[j].z),
                        __fadd_rn(v.w, u[j].w));
  }
  const float vs[4] = {v.x, v.y, v.z, v.w};
  float* gb = gram + static_cast<long long>(b) * r * r;
  float* dst = gb + static_cast<long long>(p) * r + q;
  if (vec_out) {  // r % 4 == 0: q + 3 < r
    *reinterpret_cast<float4*>(dst) = v;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (q + t < r) dst[t] = vs[t];
  }
  if (gi != gj) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (q + t < r) gb[static_cast<long long>(q + t) * r + p] = vs[t];
  }
}

}  // namespace gram

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

namespace gram {

template <int kRows>
int launch(const float* x, float* gram, float* ws, int batch, int r, int m, int splits,
           int width, cudaStream_t stream) {
  const int tiles = (r + kMacro * BB - 1) / (kMacro * BB);
  const long long pairs = static_cast<long long>(tiles) * (tiles + 1) / 2;
  if (pairs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool w4 = m % 4 == 0 && aligned(x, 16);
  auto kernel = w4 ? &ns_gram_kernel<kRows, 4> : &ns_gram_kernel<kRows, 1>;
  constexpr size_t smem = sizeof(Ring<kRows>);
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned tiles_y = static_cast<unsigned>(pairs);
  kernel<<<dim3(splits, tiles_y, batch), 32 * kWarpsOf<kRows>, smem, stream>>>(x, ws, r, m,
                                                                                 width);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  constexpr int kChunks = kWarpsOf<kRows> * kPartFloats / 4;
  const bool vec_out = r % 4 == 0 && aligned(gram, 16);
  ns_gram_sum_kernel<kRows>
      <<<dim3((kChunks + kSumThreads - 1) / kSumThreads, tiles_y, batch), kSumThreads, 0,
         stream>>>(ws, gram, r, splits, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram

}  // namespace

// m is cut into `splits` ranges of `width` columns: 1 <= splits <=
// kMaxSplits, width a positive multiple of the k slice, splits * width >= m
// (the wrapper chooses them). ws holds batch * macro tiles * splits * warps
// * kPartFloats floats (kernels/newton_schulz.py's
// ns_gram_workspace_floats). 16-byte copies need m % 4 == 0 and X on 16
// bytes, 16-byte stores r % 4 == 0 and A on 16 bytes; otherwise 4-byte ones.
extern "C" int repro_ns_gram(const float* x, float* gram, float* ws, int batch, int r, int m,
                             int splits, int width, void* stream) {
  using namespace gram;
  if (batch <= 0 || r <= 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || splits > kMaxSplits || width <= 0 || width % BK != 0 ||
      static_cast<long long>(splits) * width < m)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (r <= BB) return launch<BB>(x, gram, ws, batch, r, m, splits, width, st);
  if (r <= 2 * BB) return launch<2 * BB>(x, gram, ws, batch, r, m, splits, width, st);
  if (r <= 3 * BB) return launch<3 * BB>(x, gram, ws, batch, r, m, splits, width, st);
  if (r <= kMacro * BB) return launch<kMacro * BB>(x, gram, ws, batch, r, m, splits, width, st);
  return launch<2 * kMacro * BB>(x, gram, ws, batch, r, m, splits, width, st);
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
