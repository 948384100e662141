// Dense online-softmax attention (flash attention forward) for Hopper, in
// fp32 on the tensor cores by 3xTF32: the fp32 prefill's route.
//
// Replaces repro/kernels/flash_attention.py::_kernel. q (B, Sq, Hq, hd) and
// k, v (B, Skv, Hkv, hd) are read in the model's layout through their
// strides; query head h reads kv head h / (Hq / Hkv), so GQA needs no
// K/V expansion in memory. Out (B, Sq, Hq, hd) is contiguous, in q's dtype.
// Keys of their own length (Skv != Sq) come without a mask: an encoder's
// bidirectional attention, a decoder's cross-attention over the encoder's
// frames. A query slice at an offset q_offset (sequence-parallel
// attention: one rank's rows of a prefill against all of its keys) comes
// with any mask: query row r is absolute position q_offset + r, the masks
// and the walk's bounds compare absolute positions and the key tiles stay
// aligned at key 0. Under a mask the keys cover the slice (Skv >= q_offset
// + Sq).
//
// What it computes is the TPU kernel's function: q, k, v upcast to fp32;
// s = (q . k) * scale with scale = 1 / sqrt(hd) (a multiply, as there);
// masked entries (causal: key > query; window: query - key >= window; a
// key past Skv) set to -1e30; the running max m, sum l and the accumulator
// in fp32, P not rounded before P.V; O = acc / max(l, 1e-30). Both
// products run as 3xTF32: each fp32 operand x is split into hi = x
// truncated to TF32 and lo = x - hi (mma.cuh's split_tf32), and a.b is
// taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with fp32 accumulators, a few
// 2^-20 relative per product: fp32's accuracy, not TF32's three digits.
// exp is the hardware's (__expf: ex2.approx of x * log2(e), a few ulp);
// both keep the outputs within a few 1e-6 of the fp32 plain version.
//
// Bound: operations. 4 * hd flops per unmasked (query, key) pair against
// 2 * hd K/V values a tile shares among 64 queries. fp32 at 3 TF32 passes
// has a third of the TF32 peak (495 / 3 TFLOP/s), which still lies above
// the fp32 SIMT peak (67): SIMT FMA cannot reach this bound. mma.sync
// reaches about two thirds of the TF32 peak alone (scripts/
// tf32_mma_probe.py); here the splits, the softmax and the fragment loads
// share the issue slots with the three passes, which holds the kernel to
// about a quarter of that (PERF.md).
//
// Design:
//   * One CTA of 4 warps per (block of 64 query rows, q head, batch row),
//     blocks with the longest walks issued first; each warp owns 16 rows.
//     It walks the key tiles that hold an unmasked pair for some row of
//     its block: [lo, hi) with hi the causal diagonal (or Skv) and lo the
//     window's first key of the block's first row, as the TPU kernel's
//     `pl.when` skip. Masking runs only on tiles that may hold a masked
//     pair for some row of the warp.
//   * Q (the block's 64 rows) is staged once in shared memory as fp32. Up
//     to hd 64 each warp splits its A fragments once into registers for
//     the whole walk; above, it reads and splits them per tile. K and V
//     tiles (64 keys, 32 above hd 64 so that two CTAs fit an SM at hd 128)
//     arrive by cp.async into a 2-slot ring (16-byte copies where rows and
//     hd allow, else 4-byte; bf16 inputs by loads converted to fp32), so
//     the next tile loads while this one computes; each warp splits the
//     K/V values it reads.
//   * Fragments are read with 16-byte shared loads by relabelling the
//     reduction axes: in Q.K^T the k index t of k-step 2j + i is head dim
//     16j + 4t + 2i (and t + 4 is + 1), so one float4 of a row serves two
//     k-steps; in P.V the output columns of d-tile 4i + e are dims 32i +
//     4n + e, so one float4 of a V row serves four d-tiles. Row strides of
//     hd + 16 (Q, K) and hd + 4 (V) floats keep those loads free of bank
//     conflicts at hd 64 and 128.
//   * The three passes of a product run as three sweeps over all of a
//     warp's accumulators, so consecutive mma feed different ones.
//   * P goes from the S accumulators straight into the A fragments of
//     P.V (a C tile is an A fragment once its k index t is read as key 2t
//     and t + 4 as key 2t + 1; V's rows are read in that order), split
//     into hi/lo, unrounded otherwise. The accumulator stays in registers
//     for the walk; the row max and sum across the 4 lanes that share a
//     row by shuffles, l kept per lane and summed once at the end.
//   * Rows past Sq (Q) or Skv (K, V) and dims past hd are zero-filled, so
//     any Sq, Skv >= 1 and any hd <= 256 work (padded to 32, 64, 96, 128,
//     192 or 256); keys past Skv in the last tile are masked.
//   * No atomics; every sum runs in a fixed order and each output row is
//     written by one CTA, so two launches are bit-identical.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

template <int HDP>
struct Tile {
  static_assert(HDP % 32 == 0, "the head dim pads to a multiple of 32");
  // keys per tile: 64, or 32 above hd 64 so that two CTAs fit an SM at
  // hd 128 (shared memory)
  static constexpr int kBK = HDP <= 64 ? 64 : 32;
  static constexpr int kLdk = HDP + 16;  // Q and K rows: = 16 mod 32 floats
  static constexpr int kLdv = HDP + 4;   // V rows: = 4 mod 32 floats
  // Q's TF32 parts stay in registers for the walk up to hd 64; above, Q
  // stays in shared memory and is split per tile
  static constexpr bool kQRegs = HDP <= 64;
  static constexpr int kK = kBK * kLdk;  // floats of a K tile
  static constexpr int kSlot = kK + kBK * kLdv;  // ... of a K and a V tile
  static constexpr size_t kSmem = sizeof(float) * (kBQ * kLdk + 2 * kSlot);
};

// rows [r0, r0 + ROWS) of one head into dst[ROWS][ld] as fp32, rows >= s
// and dims >= hd zero-filled: by 16-byte cp.async (kVec: fp32, hd % 4 ==
// 0, rows on 16 bytes), 4-byte cp.async (other fp32), or loads (bf16).
// The general loops stay rolled: unrolled, their addresses stay live
// across the walk and spill.
template <typename T, int HDP, bool kVec, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long stride,
                                          int r0, int s, int hd) {
  constexpr int kPieces = HDP / 4;
  if constexpr (std::is_same<T, float>::value && kVec && kThreads % kPieces == 0) {
    // a thread copies one 16-byte column of every kStep-th row: its
    // addresses advance by a constant, so the copies cost few instructions
    constexpr int kStep = kThreads / kPieces;
    const int c = threadIdx.x % kPieces, r = threadIdx.x / kPieces;
    const bool col_ok = 4 * c < hd;
    const T* from = src + static_cast<long long>(r0 + r) * stride + 4 * c;
    float* to = dst + r * ld + 4 * c;
#pragma unroll
    for (int i = 0; i < ROWS / kStep; ++i) {
      const bool ok = col_ok && r0 + r + i * kStep < s;
      mma::cp_async16(to + i * kStep * ld, ok ? from + i * kStep * stride : src, ok);
    }
  } else if constexpr (std::is_same<T, float>::value && kVec) {
#pragma unroll 1
    for (int i = 0; i < ROWS * kPieces / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kPieces, c = e % kPieces;
      const bool ok = r0 + r < s && 4 * c < hd;
      const T* from = ok ? src + static_cast<long long>(r0 + r) * stride + 4 * c : src;
      mma::cp_async16(dst + r * ld + 4 * c, from, ok);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < ROWS * HDP / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / HDP, d = e % HDP;
      const bool ok = r0 + r < s && d < hd;
      const T* from = ok ? src + static_cast<long long>(r0 + r) * stride + d : src;
      if constexpr (std::is_same<T, float>::value)
        mma::cp_async4(dst + r * ld + d, from, ok);
      else
        dst[r * ld + d] = ok ? to_f(*from) : 0.f;
    }
  }
}

// the TF32 parts (hi, lo) of four consecutive floats at p
__device__ __forceinline__ void parts4(const float* p, unsigned (&hi)[4], unsigned (&lo)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  mma::split_tf32(x.x, hi[0], lo[0]);
  mma::split_tf32(x.y, hi[1], lo[1]);
  mma::split_tf32(x.z, hi[2], lo[2]);
  mma::split_tf32(x.w, hi[3], lo[3]);
}

template <typename T, int HDP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int s, int skv, int hq, int group, int hd, Strides qst,
                    Strides kst, Strides vst, int causal, int window, int q_offset,
                    float scale) {
  using TL = Tile<HDP>;
  constexpr int kBK = TL::kBK, kLdk = TL::kLdk, kLdv = TL::kLdv;
  constexpr bool kQRegs = TL::kQRegs;
  constexpr int kKPairs = HDP / 16;  // pairs of k-steps of Q.K^T
  constexpr int kDTiles = HDP / 8;   // 8-wide output tiles of P.V
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // Q [kBQ][kLdk]
  float* ring = qs + kBQ * kLdk;  // 2 x [K [kBK][kLdk], V [kBK][kLdv]]

  const int qblock = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qblock * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // absolute positions: the masks and the walk's bounds compare these
  const int row_w = q_offset + q0 + warp * 16;  // the warp's first row
  const int rows[2] = {row_w + g, row_w + g + 8};
  const int hk = h / group;
  const T* qp = q + b * qst.b + h * qst.h;
  const T* kp = k + b * kst.b + hk * kst.h;
  const T* vp = v + b * vst.b + hk * vst.h;

  // the K/V tiles with an unmasked pair for some row of this block
  const int q_last = q_offset + min(q0 + kBQ, s) - 1;
  const int k_end = causal ? q_last + 1 : skv;
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  auto issue = [&](int it) {
    float* ks = ring + (it & 1) * TL::kSlot;
    const int k0 = k_begin + it * kBK;
    load_rows<T, HDP, kVec, kBK>(ks, kLdk, kp, kst.s, k0, skv, hd);
    load_rows<T, HDP, kVec, kBK>(ks + TL::kK, kLdv, vp, vst.s, k0, skv, hd);
  };
  load_rows<T, HDP, kVec, kBQ>(qs, kLdk, qp, qst.s, q0, s, hd);
  mma::cp_async_commit();
  issue(0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this lane's Q: rows g and g + 8 of the warp, dims 16j + 4t .. + 3; the
  // A fragment of k-step 2j + i is {row g, k t} = Q[g][16j + 4t + 2i], k t
  // + 4 the next dim
  const float* qw = qs + (warp * 16 + g) * kLdk + 4 * t;
  unsigned qh[kQRegs ? kKPairs : 1][2][4], ql[kQRegs ? kKPairs : 1][2][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int j = 0; j < kKPairs; ++j) {
      unsigned xh[4], xl[4], yh[4], yl[4];
      parts4(qw + 16 * j, xh, xl);
      parts4(qw + 8 * kLdk + 16 * j, yh, yl);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qh[j][i][0] = xh[2 * i], qh[j][i][1] = yh[2 * i];
        qh[j][i][2] = xh[2 * i + 1], qh[j][i][3] = yh[2 * i + 1];
        ql[j][i][0] = xl[2 * i], ql[j][i][1] = yl[2 * i];
        ql[j][i][2] = xl[2 * i + 1], ql[j][i][3] = yl[2 * i + 1];
      }
    }
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();  // this tile has landed
    const float* ks = ring + (it & 1) * TL::kSlot;
    const float* vs = ks + TL::kK;
    const int k0 = k_begin + it * kBK;

    // S = Q K^T: sc[n][e] is row rows[e / 2], key k0 + 8n + 2t + e % 2.
    // The mma of one pass run over all n before the next pass, so no two
    // in a row feed the same accumulator.
    float sc[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kKPairs; ++j) {
      unsigned ah[2][4], al[2][4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[i][e] = qh[j][i][e], al[i][e] = ql[j][i][e];
      } else {
        unsigned xh[4], xl[4], yh[4], yl[4];
        parts4(qw + 16 * j, xh, xl);
        parts4(qw + 8 * kLdk + 16 * j, yh, yl);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ah[i][0] = xh[2 * i], ah[i][1] = yh[2 * i];
          ah[i][2] = xh[2 * i + 1], ah[i][3] = yh[2 * i + 1];
          al[i][0] = xl[2 * i], al[i][1] = yl[2 * i];
          al[i][2] = xl[2 * i + 1], al[i][3] = yl[2 * i + 1];
        }
      }
      // B {k t, col g} of k-step 2j + i = K[8n + g][16j + 4t + 2i], k t + 4
      // the next dim: bh[n][2i], bh[n][2i + 1]
      unsigned bh[kBK / 8][4], bl[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        parts4(ks + (8 * n + g) * kLdk + 16 * j + 4 * t, bh[n], bl[n]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
          mma::mma_tf32(sc[n], al[i], bh[n][2 * i], bh[n][2 * i + 1]);
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
          mma::mma_tf32(sc[n], ah[i], bl[n][2 * i], bl[n][2 * i + 1]);
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
          mma::mma_tf32(sc[n], ah[i], bh[n][2 * i], bh[n][2 * i + 1]);
      }
    }

    // scale and mask, only where some key of the tile may be masked for
    // some row of the warp (a warp-uniform test)
    const bool need_mask = k0 + kBK > skv || (causal && k0 + kBK - 1 > row_w) ||
                           (window > 0 && k0 <= row_w + 15 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale;
        if (need_mask) {
          const int row = rows[e >> 1], key = k0 + 8 * n + 2 * t + (e & 1);
          bool ok = key < skv;
          if (causal) ok = ok && key <= row;
          if (window > 0) ok = ok && row - key < window;
          x = ok ? x : kNegInf;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      const float corr = __expf(m[i] - m_new);
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
      m[i] = m_new;
    }

    // O += P V: the k index t of k-step n is key 8n + 2t, t + 4 is 8n + 2t + 1.
    // Again one pass over every d-tile before the next pass.
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __expf(sc[n][e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      unsigned ph[4], pl[4];
      mma::split_tf32(p[0], ph[0], pl[0]);  // row g, key 2t
      mma::split_tf32(p[2], ph[1], pl[1]);  // row g + 8, key 2t
      mma::split_tf32(p[1], ph[2], pl[2]);  // row g, key 2t + 1
      mma::split_tf32(p[3], ph[3], pl[3]);  // row g + 8, key 2t + 1
      // B {k t, col g} of d-tile 4i + e = V[8n + 2t][32i + 4g + e], k t + 4
      // the next key: bh[4i + e][0], bh[4i + e][1]
      const float* v0 = vs + (8 * n + 2 * t) * kLdv + 4 * g;
      unsigned bh[kDTiles][2], bl[kDTiles][2];
#pragma unroll
      for (int i = 0; i < HDP / 32; ++i) {
        unsigned h0[4], l0[4], h1[4], l1[4];
        parts4(v0 + 32 * i, h0, l0);
        parts4(v0 + kLdv + 32 * i, h1, l1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bh[4 * i + e][0] = h0[e], bh[4 * i + e][1] = h1[e];
          bl[4 * i + e][0] = l0[e], bl[4 * i + e][1] = l1[e];
        }
      }
#pragma unroll
      for (int jd = 0; jd < kDTiles; ++jd) mma::mma_tf32(acc[jd], pl, bh[jd][0], bh[jd][1]);
#pragma unroll
      for (int jd = 0; jd < kDTiles; ++jd) mma::mma_tf32(acc[jd], ph, bl[jd][0], bl[jd][1]);
#pragma unroll
      for (int jd = 0; jd < kDTiles; ++jd) mma::mma_tf32(acc[jd], ph, bh[jd][0], bh[jd][1]);
    }
    __syncthreads();  // every warp is done with this slot before it refills
  }

  // acc[4i + e][c]: row rows[c / 2], dim 32i + 8t + 4 (c % 2) + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = rows[r] - q_offset;  // the slice's own row
    if (row >= s) continue;
    T* o = out + ((static_cast<long long>(b) * s + row) * hq + h) * hd;
#pragma unroll
    for (int i = 0; i < HDP / 32; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = 32 * i + 8 * t + 4 * half + e;
          if (d < hd) o[d] = from_f<T>(acc[4 * i + e][2 * r + half] / den);
        }
  }
}

template <typename T, int HDP, bool kVec>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int s, int skv,
                   int hq, int hkv, int hd, Strides qst, Strides kst, Strides vst, int causal,
                   int window, int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = Tile<HDP>::kSmem;
  static_assert(smem <= 227 * 1024, "tiles exceed shared memory");
  auto kernel = flash_attention_fwd<T, HDP, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ), static_cast<unsigned>(hq),
                  static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, skv, hq, hq / hkv, hd, qst, kst, vst, causal, window, q_offset,
      scale);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int b, int s,
                     int skv, int hq, int hkv, int hd, Strides qst, Strides kst, Strides vst,
                     int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
#define REPRO_FA_CASE(HDP)                                                                   \
  return launch<T, HDP, kVec>(q, k, v, out, b, s, skv, hq, hkv, hd, qst, kst, vst, causal,    \
                              window, q_offset, scale, stream)
  if (hd <= 32) REPRO_FA_CASE(32);
  if (hd <= 64) REPRO_FA_CASE(64);
  if (hd <= 96) REPRO_FA_CASE(96);
  if (hd <= 128) REPRO_FA_CASE(128);
  if (hd <= 192) REPRO_FA_CASE(192);
  REPRO_FA_CASE(256);
#undef REPRO_FA_CASE
}

}  // namespace

// q (B, S, Hq, hd), k / v (B, Skv, Hkv, hd) with the given element strides
// of the batch, sequence and head axes (the head dim contiguous), all three
// of one dtype (fp32, or bf16 with is_bf16, upcast); out (B, S, Hq, hd)
// contiguous in that dtype. window <= 0 means no window; q_offset >= 0 the
// absolute position of q's first row; under a mask the keys cover the
// rows (Skv >= q_offset + S). The caller checks the grid limits
// (Hq, B < 65536).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int s, int skv, int hq, int hkv, int hd, long long q_sb,
                                     long long q_ss, long long q_sh, long long k_sb,
                                     long long k_ss, long long k_sh, long long v_sb,
                                     long long v_ss, long long v_sh, int causal, int window,
                                     int q_offset, float scale, int is_bf16, void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  const bool masked = causal || window > 0;
  if (skv <= 0 || hkv <= 0 || hq % hkv || hd <= 0 || hd > 256 || q_offset < 0 ||
      (masked && skv < q_offset + s))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qst{q_sb, q_ss, q_sh}, kst{k_sb, k_ss, k_sh}, vst{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(dispatch<bf16, false>(q, k, v, out, b, s, skv, hq, hkv, hd, qst,
                                                  kst, vst, causal, window, q_offset, scale, st));
  // 16-byte copies need every row of q, k and v on 16 bytes and hd % 4 == 0
  bool vec = hd % 4 == 0;
  for (const void* p : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long st4 : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh})
    vec = vec && st4 % 4 == 0;
  const cudaError_t rc =
      vec ? dispatch<float, true>(q, k, v, out, b, s, skv, hq, hkv, hd, qst, kst, vst,
                                  causal, window, q_offset, scale, st)
          : dispatch<float, false>(q, k, v, out, b, s, skv, hq, hkv, hd, qst, kst, vst,
                                   causal, window, q_offset, scale, st);
  return static_cast<int>(rc);
}
