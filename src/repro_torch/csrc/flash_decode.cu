// Paged single-query GQA attention (flash decode) for Hopper.
//
// Replaces repro/kernels/flash_decode.py::_kernel and its jnp split merge.
// One decode token per slot attends to that slot's K/V, which lie scattered
// over fixed-size blocks of a global pool and are found through the slot's
// row of the block table; the cache is never densified.
//
// Bound: bytes. Each (slot, kv head) reads its valid K and V rows once and
// does 2 x group flops per value read, below the card's ~20 fp32 flops per
// byte for the group sizes models use: the kernel is as fast as its K/V
// reads.
//
// Design:
//   * One CTA per (b * Hkv + h, split). It walks its split's columns of the
//     block table in order and keeps the online-softmax state (acc, m, l)
//     of all `group` = Hq / Hkv query heads of kv head h in shared memory,
//     so each K/V row is read once for the whole group.
//   * Only the valid tokens of a block are read: [max(start, length -
//     window), min(start + bs, length)). A block with none is skipped and
//     its pool block is never read, so stale or poisoned entries and the
//     zero padding of unused columns cannot leak in. The TPU kernel masks
//     the same positions to -1e30, whose softmax weight is exactly 0.
//   * Tokens go in chunks of up to 32 within a block. The CTA first stages
//     the chunk's K and V rows in shared memory, every thread keeping a
//     batch of independent loads in flight. Then one warp per token
//     computes the `group` scores (lanes split hd), one warp per query head
//     does the chunk's max / exp / sum, and each thread owns (head, d)
//     elements of acc. The next block's table entry is read one block
//     ahead.
//   * The walk within a CTA is serial, with four barriers per chunk, so
//     the time follows the longest split's walk, not the bytes: more
//     splits mean more CTAs in flight.
//   * fp32 arithmetic throughout; K, V and q may be bf16 or fp32.
//   * The split partials (acc, m, l) go to fp32 scratch, and a second
//     small kernel merges them with the max-shift algebra of the JAX
//     epilogue and writes the output in q's dtype. A slot of length 0 has
//     only empty splits and gets an exact zero row.
//   * No atomics; every sum runs in a fixed order, so results are
//     deterministic and one slot's output does not depend on its
//     neighbours.
#include <climits>
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // tokens per chunk: one per lane
constexpr int kMaxHd = 256;
constexpr int kBatch = 8;         // K and V loads each thread keeps in flight
constexpr float kNegInf = -1e30f;
constexpr int kMergeThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
flash_decode_partials(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                      const KT* __restrict__ v_pool, const int* __restrict__ table,
                      const int* __restrict__ lengths, float* __restrict__ o_part,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      int hkv, int group, int hd, int nb, int bs, int maxb, int bps,
                      int window, float scale) {
  extern __shared__ float smem[];
  const int gh = group * hd;
  float* qs = smem;                 // (group, hd) query heads, fp32
  float* acc = qs + gh;             // (group, hd) unnormalized output
  float* ks = acc + gh;             // (kChunk, hd) this chunk's K rows
  float* vs = ks + kChunk * hd;     // (kChunk, hd) and V rows
  float* ps = vs + kChunk * hd;     // (group, kChunk) scores, then weights
  float* ms = ps + group * kChunk;  // (group) running max
  float* ls = ms + group;           // (group) running denominator
  float* cs = ls + group;           // (group) this chunk's rescale factor

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bh / hkv, h = bh - b * hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // q (B, Hq, hd): heads h*group .. h*group+group-1 of slot b are contiguous
  const QT* qb = q + (static_cast<long long>(b) * hkv + h) * gh;
  for (int i = tid; i < gh; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  const int lo_win = window > 0 ? length - window : INT_MIN;
  const long long row_stride = static_cast<long long>(hkv) * hd;  // one token
  const int* trow = table + static_cast<long long>(b) * maxb;
  const int c0 = split * bps;
  const int c1 = min(c0 + bps, maxb);
  bool bad_entry = false;
  // the next column's table entry is read one block ahead, hiding its latency
  int blk_next = c0 < c1 && c0 * bs < length ? trow[c0] : 0;

  for (int col = c0; col < c1; ++col) {
    const int start = col * bs;
    if (start >= length) break;               // later columns start later
    const int blk = blk_next;
    if (col + 1 < c1 && start + bs < length) blk_next = trow[col + 1];
    const int lo = max(start, lo_win);
    const int hi = min(start + bs, length);
    if (lo >= hi) continue;                   // wholly before the window
    if (blk < 0 || blk >= nb) {               // poison rather than fault
      bad_entry = true;
      continue;
    }
    // token t of the slot is row t - start of pool block blk
    const long long base = static_cast<long long>(blk) * bs * row_stride + h * hd;

    for (int t0 = lo; t0 < hi; t0 += kChunk) {
      const int nt = min(kChunk, hi - t0);
      const int n = nt * hd;
      const KT* kc = k_pool + base + static_cast<long long>(t0 - start) * row_stride;
      const KT* vc = v_pool + base + static_cast<long long>(t0 - start) * row_stride;
      // stage the chunk's K and V rows: each thread issues a batch of
      // independent loads before it stores any, so they are in flight
      // together instead of one latency each
      for (int i0 = 0; i0 < n; i0 += kThreads * kBatch) {
        float kv[kBatch], vv[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * kThreads + tid;
          if (i < n) {
            const int t = i / hd;
            const long long off = t * row_stride + (i - t * hd);
            kv[j] = to_f(kc[off]);
            vv[j] = to_f(vc[off]);
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * kThreads + tid;
          if (i < n) {
            ks[i] = kv[j];
            vs[i] = vv[j];
          }
        }
      }
      __syncthreads();
      // scores: one warp per token, lanes over hd, all query heads
      for (int tt = warp; tt < nt; tt += kWarps) {
        const float* kr = ks + tt * hd;
        for (int g = 0; g < group; ++g) {
          const float* qg = qs + g * hd;
          float part = 0.f;
          for (int d = lane; d < hd; d += 32) part = fmaf(qg[d], kr[d], part);
          part = warp_sum(part);
          if (lane == 0) ps[g * kChunk + tt] = part * scale;
        }
      }
      __syncthreads();
      // online softmax: one warp per query head, one lane per token
      for (int g = warp; g < group; g += kWarps) {
        const float s = lane < nt ? ps[g * kChunk + lane] : kNegInf;
        const float m_prev = ms[g];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p = lane < nt ? expf(s - m_new) : 0.f;
        const float psum = warp_sum(p);
        ps[g * kChunk + lane] = p;
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          cs[g] = corr;
          ls[g] = ls[g] * corr + psum;
          ms[g] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * corr + p @ V: each thread owns (head, d) elements
      for (int i = tid; i < gh; i += kThreads) {
        const int g = i / hd, d = i - g * hd;
        const float* pg = ps + g * kChunk;
        float pv = 0.f;
        for (int tt = 0; tt < nt; ++tt) pv = fmaf(pg[tt], vs[tt * hd + d], pv);
        acc[i] = fmaf(acc[i], cs[g], pv);
      }
      __syncthreads();
    }
  }

  // partials (num_splits, B*Hkv, group, hd) and (num_splits, B*Hkv, group, 1)
  const long long row = static_cast<long long>(split) * gridDim.x + bh;
  for (int i = tid; i < gh; i += kThreads) o_part[row * gh + i] = bad_entry ? NAN : acc[i];
  for (int g = tid; g < group; g += kThreads) {
    m_part[row * group + g] = ms[g];
    l_part[row * group + g] = ls[g];
  }
}

// Max-shift merge of the split partials (the JAX epilogue): rows = B * Hq.
template <typename OT>
__global__ void __launch_bounds__(kMergeThreads)
flash_decode_merge(const float* __restrict__ o_part, const float* __restrict__ m_part,
                   const float* __restrict__ l_part, OT* __restrict__ out,
                   int num_splits, int rows, int hd) {
  const long long idx = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * hd) return;
  const int r = static_cast<int>(idx / hd);
  float m_star = kNegInf;
  for (int s = 0; s < num_splits; ++s)
    m_star = fmaxf(m_star, m_part[static_cast<long long>(s) * rows + r]);
  // an all-empty row keeps every alpha at exp(-5e29) = 0: a zero output
  m_star = fmaxf(m_star, kNegInf / 2);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const long long sr = static_cast<long long>(s) * rows + r;
    const float alpha = expf(m_part[sr] - m_star);
    l += alpha * l_part[sr];
    a += alpha * o_part[static_cast<long long>(s) * rows * hd + idx];
  }
  out[idx] = from_f<OT>(a / fmaxf(l, 1e-30f));
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* table,
                   const int* lengths, float* o_part, float* m_part, float* l_part,
                   void* out, int b, int hq, int hkv, int hd, int nb, int bs, int maxb,
                   int num_splits, int window, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const int bps = (maxb + num_splits - 1) / num_splits;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(group + kChunk) * hd + static_cast<size_t>(group) * kChunk +
       3 * group);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = flash_decode_partials<QT, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(static_cast<unsigned>(b * hkv), static_cast<unsigned>(num_splits));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      table, lengths, o_part, m_part, l_part, hkv, group, hd, nb, bs, maxb, bps, window,
      scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const long long total = static_cast<long long>(b) * hq * hd;
  const unsigned blocks = static_cast<unsigned>((total + kMergeThreads - 1) / kMergeThreads);
  flash_decode_merge<QT><<<blocks, kMergeThreads, 0, stream>>>(
      o_part, m_part, l_part, static_cast<QT*>(out), num_splits, b * hq, hd);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hq, hd) and out (B, Hq, hd) in one dtype, pools (NB, bs, Hkv, hd) of
// one layer, table (B, maxb) int32, lengths (B,) int32; o_part, m_part and
// l_part are fp32 scratch of (num_splits, B*Hkv, group, hd | 1). The caller
// clamps num_splits to [1, maxb]. window <= 0 means no window.
extern "C" int repro_flash_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const int* table, const int* lengths, float* o_part,
                                  float* m_part, float* l_part, void* out, int b, int hq,
                                  int hkv, int hd, int nb, int bs, int maxb, int num_splits,
                                  int window, float scale, int q_bf16, int kv_bf16,
                                  void* stream) {
  if (b <= 0 || hq <= 0 || hd <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv || hd > kMaxHd || bs <= 0 || maxb <= 0 || num_splits < 1 ||
      num_splits > maxb)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (q_bf16 && kv_bf16)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, table, lengths, o_part,
                                              m_part, l_part, out, b, hq, hkv, hd, nb, bs,
                                              maxb, num_splits, window, scale, s);
  else if (q_bf16)
    rc = launch<__nv_bfloat16, float>(q, k_pool, v_pool, table, lengths, o_part, m_part,
                                      l_part, out, b, hq, hkv, hd, nb, bs, maxb,
                                      num_splits, window, scale, s);
  else if (kv_bf16)
    rc = launch<float, __nv_bfloat16>(q, k_pool, v_pool, table, lengths, o_part, m_part,
                                      l_part, out, b, hq, hkv, hd, nb, bs, maxb,
                                      num_splits, window, scale, s);
  else
    rc = launch<float, float>(q, k_pool, v_pool, table, lengths, o_part, m_part, l_part,
                              out, b, hq, hkv, hd, nb, bs, maxb, num_splits, window, scale,
                              s);
  return static_cast<int>(rc);
}
