// Paged single-query GQA attention (flash decode) for Hopper.
//
// Replaces repro/kernels/flash_decode.py::_kernel and its jnp split merge.
// One decode token per slot attends to that slot's K/V, which lie scattered
// over fixed-size blocks of a global pool and are found through the slot's
// row of the block table; the cache is never densified.
//
// What it computes: for each slot b and query head, softmax((q . k) *
// scale) . V over the slot's valid tokens [max(0, length - window),
// length), in fp32, from q and pools in bf16 or fp32; the caller's
// `num_splits` column ranges of the table merged with the max-shift
// algebra of the JAX epilogue; the output in q's dtype. A slot of length 0
// gets an exact zero row; a table entry outside the pool that a valid
// token needs poisons the slot's kv-head rows with NaN instead of
// faulting.
//
// Bound: bytes. Each (slot, kv head) reads its valid K and V rows once and
// does 2 x group flops per value read, far below the card's flops per
// byte: the least time is the K/V bytes over the memory rate (about 10 us
// for phase 5's serving shape).
//
// Design:
//   * The work is cut by the table, not by the caller's splits: each
//     caller split is cut further into fixed ranges of `cols` table
//     columns (about 128 tokens; the wrapper plans them), and each (range,
//     slot x kv head, tile of <= GT query heads) is one CTA. Ranges that
//     hold no valid token (past the length, wholly before the window, or
//     past the table) exit at once, so the time follows the valid tokens
//     over the whole card, not the longest serial walk.
//   * In a CTA, warp w takes the range's columns w, w + 4, ...; the table
//     entry is read by the warp that needs it. Only the valid rows of a
//     block are read, so stale or poisoned entries and the padding of
//     unused columns never leak in.
//   * Vector path (bf16 pools, hd % 8 == 0, 16-byte aligned pools): a K or
//     V row is read as 16-byte vectors of 8 bf16, LPR = hd / 8 (rounded up
//     to a power of two) lanes per row, so a warp reads 32 / LPR rows per
//     pass; each lane issues the loads of U passes (K and V) before it
//     uses any, so they are in flight together. A scalar path (one element
//     a lane, 32 lanes per row) takes fp32 pools and odd head dims.
//   * Online softmax per lane, in registers: a lane keeps (m, l, acc) of
//     the rows it read for the GT query heads of its tile; the score of a
//     row is summed over its LPR lanes by xor shuffles (so every lane of
//     the row holds the same value). No barrier in the loop. The lanes'
//     states are merged by shuffles, then the four warps' through shared
//     memory, once, at the end, into the range's partial (acc, m, l) in
//     fp32 scratch.
//   * A second small kernel merges the live ranges' partials of each
//     output row in range order (the same max-shift algebra: finer
//     partials give the same function up to the order of fp32 sums) and
//     writes q's dtype. A slot with no live range gets 0 / 1e-30 = 0.
//   * No atomics; every sum runs in a fixed order, so a relaunch is
//     bit-identical and one slot's output does not depend on its
//     neighbours.
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC pool elements one lane loads at once, kept raw until used
template <typename KT, int VEC> struct Piece;

template <> struct Piece<bf16, 8> {
  unsigned w[4];
  __device__ __forceinline__ void load(const bf16* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  // element e: the low half of a word is the even element (exact widening)
  __device__ __forceinline__ float operator[](int e) const {
    const unsigned x = w[e >> 1];
    return __uint_as_float(e & 1 ? x & 0xffff0000u : x << 16);
  }
};

template <typename KT> struct Piece<KT, 1> {
  float x;
  __device__ __forceinline__ void load(const KT* p) { x = to_f(__ldg(p)); }
  __device__ __forceinline__ void zero() { x = 0.f; }
  __device__ __forceinline__ float operator[](int) const { return x; }
};

// The table columns each caller split is cut into: split s holds columns
// [s * bps, min((s + 1) * bps, maxb)), cut into ranges of `cols`;
// range p = s * per_split + j.
struct Plan {
  int bps, cols, per_split, maxb;

  __device__ __forceinline__ void columns(int p, int& c_lo, int& c_hi) const {
    const int s = p / per_split, j = p - s * per_split;
    c_lo = s * bps + j * cols;
    c_hi = min(min(c_lo + cols, (s + 1) * bps), maxb);
  }
  // whether range p holds a valid token of a slot of `length` whose first
  // valid token is at lo_win (the caller keeps maxb * bs < 2^31)
  __device__ __forceinline__ bool live(int p, int bs, int length, int lo_win) const {
    int c_lo, c_hi;
    columns(p, c_lo, c_hi);
    return c_lo < c_hi && c_lo * bs < length && c_hi * bs > lo_win;
  }
};

__device__ __forceinline__ int first_valid(int length, int window) {
  return window > 0 ? length - window : INT_MIN;
}

// passes of a warp (32 / LPR rows each) whose loads a lane issues before
// it uses any: about 16 rows, at most 8 passes, 4 for wide query tiles
// (registers) and on the scalar path
template <int VEC, int LPR, int GT>
__host__ __device__ constexpr int passes() {
  if (VEC == 1) return 4;
  const int rows = 32 / LPR;
  const int cap = GT >= 8 ? 4 : 8;
  const int u = rows >= 16 ? 1 : 16 / rows;
  return u < cap ? u : cap;
}

template <typename KT, int VEC, int LPR, int NV, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_ranges(const void* __restrict__ q, int q_bf16, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool, const int* __restrict__ table,
                    const int* __restrict__ lengths, float* __restrict__ o_part,
                    float* __restrict__ m_part, float* __restrict__ l_part, int hkv, int group,
                    int hd, int nb, int bs, int rows, Plan plan, int window, float scale) {
  constexpr int ROWS = 32 / LPR;  // pool rows one pass of a warp reads
  constexpr int DPL = NV * VEC;   // head dims a lane owns
  constexpr int HDP = LPR * DPL;  // the head dim, padded
  constexpr int U = passes<VEC, LPR, GT>();
  __shared__ float ws_acc[kWarps][GT][HDP];
  __shared__ float ws_m[kWarps][GT], ws_l[kWarps][GT];

  const int tiles = (group + GT - 1) / GT;
  const int bh = blockIdx.x / tiles, g0 = (blockIdx.x - bh * tiles) * GT;
  const int b = bh / hkv, h = bh - b * hkv;
  const int p = blockIdx.y;
  const int length = lengths[b];
  const int lo_win = first_valid(length, window);
  if (!plan.live(p, bs, length, lo_win)) return;  // the merge skips it too
  int c_lo, c_hi;
  plan.columns(p, c_lo, c_hi);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % LPR, r = lane / LPR;
  // lane dims: (jv * LPR + c) * VEC + e

  float qf[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int jv = 0; jv < NV; ++jv)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = (jv * LPR + c) * VEC + e;
        const long long i = (static_cast<long long>(bh) * group + g0 + g) * hd + d;
        float x = 0.f;
        if (g0 + g < group && d < hd)
          x = q_bf16 ? __bfloat162float(static_cast<const bf16*>(q)[i])
                     : static_cast<const float*>(q)[i];
        qf[g][jv * VEC + e] = x;
      }

  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  bool bad = false;
  const long long row_stride = static_cast<long long>(hkv) * hd;  // one token
  const int* trow = table + static_cast<long long>(b) * plan.maxb;
  for (int col = c_lo + warp; col < c_hi; col += kWarps) {
    const int start = col * bs;
    const int lo = max(start, lo_win), hi = min(start + bs, length);
    if (lo >= hi) continue;  // no valid token in this block
    const int blk = trow[col];
    if (blk < 0 || blk >= nb) {  // poison rather than fault
      bad = true;
      continue;
    }
    // token t of the slot is row t - start of pool block blk
    const KT* kb = k_pool + static_cast<long long>(blk) * bs * row_stride + h * hd;
    const KT* vb = v_pool + static_cast<long long>(blk) * bs * row_stride + h * hd;
    for (int t0 = lo; t0 < hi; t0 += U * ROWS) {
      Piece<KT, VEC> kp[U][NV], vp[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * ROWS + r;
#pragma unroll
        for (int jv = 0; jv < NV; ++jv) {
          const int d = (jv * LPR + c) * VEC;
          if (t < hi && d < hd) {
            const long long off = (t - start) * row_stride + d;
            kp[u][jv].load(kb + off);
            vp[u][jv].load(vb + off);
          } else {
            kp[u][jv].zero();
            vp[u][jv].zero();
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float s[U];
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part = 0.f;
#pragma unroll
          for (int jv = 0; jv < NV; ++jv)
#pragma unroll
            for (int e = 0; e < VEC; ++e) part = fmaf(qf[g][jv * VEC + e], kp[u][jv][e], part);
#pragma unroll
          for (int off = 1; off < LPR; off <<= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          s[u] = part * scale;
          if (t0 + u * ROWS + r < hi) mx = fmaxf(mx, s[u]);
        }
        const float corr = expf(m[g] - mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u] = t0 + u * ROWS + r < hi ? expf(s[u] - mx) : 0.f;
          psum += s[u];
        }
        l[g] = l[g] * corr + psum;
#pragma unroll
        for (int jv = 0; jv < NV; ++jv)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float a = acc[g][jv * VEC + e] * corr;
#pragma unroll
            for (int u = 0; u < U; ++u) a = fmaf(s[u], vp[u][jv][e], a);
            acc[g][jv * VEC + e] = a;
          }
        m[g] = mx;
      }
    }
  }

  // merge the lanes of a warp that read other rows (same dims): xor over
  // the row bits of the lane id
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), ao = expf(mo - mn);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[g][i] = acc[g][i] * a + __shfl_xor_sync(0xffffffffu, acc[g][i], off) * ao;
      m[g] = mn;
    }
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int jv = 0; jv < NV; ++jv)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          ws_acc[warp][g][(jv * LPR + c) * VEC + e] = acc[g][jv * VEC + e];
      if (c == 0) {
        ws_m[warp][g] = m[g];
        ws_l[warp][g] = l[g];
      }
    }
  }
  const bool any_bad = __syncthreads_or(bad);

  // merge the warps, in order, into the range's partial
  for (int i = threadIdx.x; i < GT * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    if (g0 + g >= group) break;
    float ms = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, ws_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float alpha = expf(ws_m[w][g] - ms);
      lsum += alpha * ws_l[w][g];
      a += alpha * ws_acc[w][g][d];
    }
    const long long row = static_cast<long long>(p) * rows + bh * group + g0 + g;
    o_part[row * hd + d] = any_bad ? NAN : a;
    if (d == 0) {
      m_part[row] = ms;
      l_part[row] = lsum;
    }
  }
}

// Max-shift merge of the live ranges' partials (the JAX epilogue), one
// thread per output element: rows = B * Hq.
template <typename OT>
__global__ void __launch_bounds__(kMergeThreads)
flash_decode_merge(const float* __restrict__ o_part, const float* __restrict__ m_part,
                   const float* __restrict__ l_part, const int* __restrict__ lengths,
                   OT* __restrict__ out, int rows, int hq, int hd, int bs, int parts, Plan plan,
                   int window) {
  const long long idx = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * hd) return;
  const int r = static_cast<int>(idx / hd);
  const int length = lengths[r / hq];
  const int lo_win = first_valid(length, window);
  float m_star = kNegInf;
  for (int p = 0; p < parts; ++p)
    if (plan.live(p, bs, length, lo_win))
      m_star = fmaxf(m_star, m_part[static_cast<long long>(p) * rows + r]);
  // a slot with no live range keeps l = a = 0: a zero row
  m_star = fmaxf(m_star, kNegInf / 2);
  float l = 0.f, a = 0.f;
  for (int p = 0; p < parts; ++p) {
    if (!plan.live(p, bs, length, lo_win)) continue;
    const long long pr = static_cast<long long>(p) * rows + r;
    const float alpha = expf(m_part[pr] - m_star);
    l += alpha * l_part[pr];
    a += alpha * o_part[static_cast<long long>(p) * rows * hd + idx];
  }
  out[idx] = from_f<OT>(a / fmaxf(l, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  const int *table, *lengths;
  float *o_part, *m_part, *l_part;
  void* out;
  int b, hq, hkv, hd, nb, bs, parts, window, q_bf16;
  Plan plan;
  float scale;
  cudaStream_t stream;
};

template <typename KT, int VEC, int LPR, int NV, int GT>
cudaError_t launch(const Args& a) {
  const int group = a.hq / a.hkv;
  const int tiles = (group + GT - 1) / GT;
  const dim3 grid(static_cast<unsigned>(a.b * a.hkv * tiles), static_cast<unsigned>(a.parts));
  flash_decode_ranges<KT, VEC, LPR, NV, GT><<<grid, kThreads, 0, a.stream>>>(
      a.q, a.q_bf16, static_cast<const KT*>(a.k), static_cast<const KT*>(a.v), a.table,
      a.lengths, a.o_part, a.m_part, a.l_part, a.hkv, group, a.hd, a.nb, a.bs, a.b * a.hq,
      a.plan, a.window, a.scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const long long total = static_cast<long long>(a.b) * a.hq * a.hd;
  const unsigned blocks = static_cast<unsigned>((total + kMergeThreads - 1) / kMergeThreads);
  if (a.q_bf16)
    flash_decode_merge<bf16><<<blocks, kMergeThreads, 0, a.stream>>>(
        a.o_part, a.m_part, a.l_part, a.lengths, static_cast<bf16*>(a.out), a.b * a.hq, a.hq,
        a.hd, a.bs, a.parts, a.plan, a.window);
  else
    flash_decode_merge<float><<<blocks, kMergeThreads, 0, a.stream>>>(
        a.o_part, a.m_part, a.l_part, a.lengths, static_cast<float*>(a.out), a.b * a.hq, a.hq,
        a.hd, a.bs, a.parts, a.plan, a.window);
  return cudaGetLastError();
}

// the query-head tile: the group rounded up to a power of two, at most 8
template <typename KT, int VEC, int LPR, int NV>
cudaError_t launch_tiles(const Args& a) {
  const int group = a.hq / a.hkv;
  if (group <= 1) return launch<KT, VEC, LPR, NV, 1>(a);
  if (group <= 2) return launch<KT, VEC, LPR, NV, 2>(a);
  if (group <= 4) return launch<KT, VEC, LPR, NV, 4>(a);
  return launch<KT, VEC, LPR, NV, 8>(a);
}

// 16-byte vectors of 8 bf16: LPR = hd / 8 rounded up to a power of two
cudaError_t launch_vector(const Args& a) {
  const int pieces = a.hd / 8;
  if (pieces <= 1) return launch_tiles<bf16, 8, 1, 1>(a);
  if (pieces <= 2) return launch_tiles<bf16, 8, 2, 1>(a);
  if (pieces <= 4) return launch_tiles<bf16, 8, 4, 1>(a);
  if (pieces <= 8) return launch_tiles<bf16, 8, 8, 1>(a);
  if (pieces <= 16) return launch_tiles<bf16, 8, 16, 1>(a);
  return launch_tiles<bf16, 8, 32, 1>(a);
}

// one element a lane, 32 lanes per row, NV = hd / 32 rounded up to a power
// of two; query heads in tiles of 4
template <typename KT>
cudaError_t launch_scalar(const Args& a) {
  const int nv = (a.hd + 31) / 32;
  if (nv <= 1) return launch<KT, 1, 32, 1, 4>(a);
  if (nv <= 2) return launch<KT, 1, 32, 2, 4>(a);
  if (nv <= 4) return launch<KT, 1, 32, 4, 4>(a);
  return launch<KT, 1, 32, 8, 4>(a);
}

}  // namespace

// q (B, Hq, hd) and out (B, Hq, hd) in one dtype, pools (NB, bs, Hkv, hd) of
// one layer, table (B, maxb) int32, lengths (B,) int32. The caller plans
// the ranges (num_splits, bps, cols, per_split: split s holds table
// columns [s * bps, (s + 1) * bps) cut into per_split ranges of cols) and
// passes fp32 scratch o_part (num_splits * per_split, B * Hq, hd), m_part
// and l_part (num_splits * per_split, B * Hq). vec: the 16-byte path (bf16
// pools, hd % 8 == 0, both pools on 16 bytes), else the scalar path.
// window <= 0 means no window.
extern "C" int repro_flash_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const int* table, const int* lengths, float* o_part,
                                  float* m_part, float* l_part, void* out, int b, int hq,
                                  int hkv, int hd, int nb, int bs, int maxb, int num_splits,
                                  int bps, int cols, int per_split, int window, float scale,
                                  int q_bf16, int kv_bf16, int vec, void* stream) {
  if (b <= 0 || hq <= 0 || hd <= 0) return static_cast<int>(cudaSuccess);
  const long long parts = static_cast<long long>(num_splits) * per_split;
  if (hkv <= 0 || hq % hkv || hd > kMaxHd || bs <= 0 || maxb <= 0 || num_splits < 1 ||
      bps < 1 || static_cast<long long>(num_splits) * bps < maxb || cols < 1 ||
      per_split < 1 || static_cast<long long>(per_split) * cols < bps || parts > 65535 ||
      static_cast<long long>(maxb) * bs >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (!kv_bf16 || hd % 8 || reinterpret_cast<uintptr_t>(k_pool) % 16 ||
              reinterpret_cast<uintptr_t>(v_pool) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k_pool,    v_pool, table, lengths, o_part,
               m_part, l_part, out,    b,     hq,      hkv,
               hd,   nb,        bs,     static_cast<int>(parts), window, q_bf16,
               Plan{bps, cols, per_split, maxb}, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t rc;
  if (vec)
    rc = launch_vector(a);
  else if (kv_bf16)
    rc = launch_scalar<bf16>(a);
  else
    rc = launch_scalar<float>(a);
  return static_cast<int>(rc);
}
