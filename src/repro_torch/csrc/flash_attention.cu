// Dense online-softmax attention (flash attention forward) for Hopper.
//
// Replaces repro/kernels/flash_attention.py::_kernel. q (B, S, Hq, hd) and
// k, v (B, S, Hkv, hd) are read in the model's layout through their
// strides; query head h reads kv head h / (Hq / Hkv), so GQA needs no
// K/V expansion in memory. Out (B, S, Hq, hd) is contiguous, in q's dtype.
//
// What it computes is the TPU kernel's function: q, k, v upcast to fp32;
// s = (q . k) * scale with scale = 1 / sqrt(hd) (a multiply, as there);
// masked entries (causal: key > query; window: query - key >= window; a
// key past S) set to -1e30; the running max m, sum l and the accumulator
// in fp32, P not rounded before P.V; O = acc / max(l, 1e-30).
//
// Bound: operations. Each (query, unmasked key) pair costs 4 * hd flops
// against 2 * hd K/V values that stay in shared memory for a whole tile of
// queries, far above the card's bytes-to-flops balance. This first kernel
// is SIMT fp32 FMA (no tensor cores), so it runs at a fraction of the fp32
// peak and far from the bf16 tensor-core bound; `mma.sync` / `wgmma` tiles
// and TMA loads are the way to that bound.
//
// Design:
//   * One CTA of 256 threads per (query block of 64 rows, q head, batch
//     row). It walks the K/V tiles of 64 keys in order, only those that
//     hold an unmasked pair for some row of its block: [lo, hi) with hi
//     the causal diagonal (or S) and lo the window's first key of the
//     block's first row, as the TPU kernel's `pl.when` skip. Blocks are
//     issued longest walk first.
//   * Thread (tr, tc) of a 16 x 16 grid owns rows 4 tr .. 4 tr + 3 of the
//     block. For S = Q K^T it owns key columns 4 tc .. 4 tc + 3 of the
//     tile; for O it owns the head dims 64 j + 4 tc .. + 3. Q and the K
//     tile are staged transposed (dim-major) so each step of the dot
//     product reads one float4 of Q and one of K for 16 FMAs; P goes
//     through shared memory, transposed, for the P.V product, which reads
//     one float4 of P and one of V per 16 FMAs.
//   * The online-softmax state (m, l) of a row lives in the registers of
//     the 16 threads that share the row, reduced with shuffles; the
//     accumulator stays in registers for the whole walk.
//   * K and V share one shared-memory buffer (K transposed, then V in
//     rows), so a head dim of 128 needs 87 KB and two CTAs fit an SM.
//   * Loads are synchronous, bounds-masked (rows past S read as 0), so any
//     S >= 1 works; any group and hd <= 256 (padded to a multiple of 64
//     in shared memory).
//   * No atomics; every sum runs in a fixed order and each output row is
//     written by one CTA, so two launches are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 row groups x 16 column groups
constexpr int kLd = kBQ + 4;       // row stride of the transposed tiles
constexpr int kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "Q, K and P tiles share one transposed stride");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// sum / max over the 16 lanes that share a row (lanes differing in bits 0-3)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int NCH>
constexpr size_t smem_bytes() {
  // q^T (HDP, kLd), K^T (HDP, kLd) / V (kBK, HDP), P^T (kBK, kLd)
  return sizeof(float) * (2 * static_cast<size_t>(64 * NCH) * kLd + kBK * kLd);
}

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

// Stage rows [r0, r0 + kBQ) of one head into shared memory as fp32: one
// warp per row, lanes over the head dim; rows past S read as 0.
// Transposed (dst[d * kLd + r]) or in rows (dst[r * ld + d]).
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride, int r0,
                                      int s, int hd, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const bool in = r0 + r < s;
    const T* row = src + static_cast<long long>(r0 + r) * row_stride;
    for (int d = lane; d < hd; d += 32) {
      const float x = in ? to_f(row[d]) : 0.f;
      if (kTransposed)
        dst[d * kLd + r] = x;
      else
        dst[r * ld + d] = x;
    }
  }
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int s, int hq, int group, int hd, Strides qst,
                    Strides kst, Strides vst, int causal, int window, float scale) {
  constexpr int HDP = 64 * NCH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // q^T: qs[d * kLd + r]
  float* kvs = qs + HDP * kLd;      // K^T: kvs[d * kLd + c], then V: kvs[c * HDP + d]
  float* ps = kvs + HDP * kLd;      // P^T: ps[c * kLd + r]

  const int qblock = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qblock * kBQ;
  const int tid = threadIdx.x, tc = tid & 15, tr = tid >> 4;
  const int hk = h / group;

  const T* qp = q + b * qst.b + h * qst.h;
  const T* kp = k + b * kst.b + hk * kst.h;
  const T* vp = v + b * vst.b + hk * vst.h;

  stage<T, true>(qs, qp, qst.s, q0, s, hd, kLd);

  // the K/V tiles with an unmasked pair for some row of this block
  const int q_last = min(q0 + kBQ, s) - 1;
  const int k_end = causal ? q_last + 1 : s;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  float acc[4][4 * NCH];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NCH; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's reads of kvs and ps are done
    stage<T, true>(kvs, kp, kst.s, k0, s, hd, kLd);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * kLd + 4 * tr);
      const float4 kk = *reinterpret_cast<const float4*>(kvs + d * kLd + 4 * tc);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(av[i], kv[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * tr + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 4 * tc + c;
        bool ok = key < s;
        if (causal) ok = ok && row >= key;
        if (window > 0) ok = ok && row - key < window;
        sc[i][c] = ok ? sc[i][c] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[i][c] = expf(sc[i][c] - m_new);
        sum += sc[i][c];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NCH; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(ps + (4 * tc + c) * kLd + 4 * tr) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    __syncthreads();  // K^T reads done, P visible
    stage<T, false>(kvs, vp, vst.s, k0, s, hd, HDP);
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(ps + c * kLd + 4 * tr);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(kvs + c * HDP + 64 * j + 4 * tc);
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * j + e] = fmaf(pv[i], vx[e], acc[i][4 * j + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * s + row) * hq + h) * hd;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * j + 4 * tc + e;
        if (d < hd) o[d] = from_f<T>(acc[i][4 * j + e] / den);
      }
  }
}

template <typename T, int NCH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int s, int hq,
                   int hkv, int hd, Strides qst, Strides kst, Strides vst, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NCH>();
  static_assert(smem <= static_cast<size_t>(kMaxSmem), "tile exceeds shared memory");
  auto kernel = flash_attention_fwd<T, NCH>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ), static_cast<unsigned>(hq),
                  static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, hq, hq / hkv, hd, qst, kst, vst, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int b, int s,
                     int hq, int hkv, int hd, Strides qst, Strides kst, Strides vst, int causal,
                     int window, float scale, cudaStream_t stream) {
  switch ((hd + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, out, b, s, hq, hkv, hd, qst, kst, vst, causal, window,
                          scale, stream);
    case 2:
      return launch<T, 2>(q, k, v, out, b, s, hq, hkv, hd, qst, kst, vst, causal, window,
                          scale, stream);
    case 3:
      return launch<T, 3>(q, k, v, out, b, s, hq, hkv, hd, qst, kst, vst, causal, window,
                          scale, stream);
    default:
      return launch<T, 4>(q, k, v, out, b, s, hq, hkv, hd, qst, kst, vst, causal, window,
                          scale, stream);
  }
}

}  // namespace

// q (B, S, Hq, hd), k / v (B, S, Hkv, hd) with the given element strides of
// the batch, sequence and head axes (the head dim contiguous), all three
// of one dtype (fp32, or bf16 with is_bf16); out (B, S, Hq, hd) contiguous
// in that dtype. window <= 0 means no window. The caller checks the grid
// limits (Hq, B < 65536).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int s, int hq, int hkv, int hd, long long q_sb,
                                     long long q_ss, long long q_sh, long long k_sb,
                                     long long k_ss, long long k_sh, long long v_sb,
                                     long long v_ss, long long v_sh, int causal, int window,
                                     float scale, int is_bf16, void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv || hd <= 0 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qst{q_sb, q_ss, q_sh}, kst{k_sb, k_ss, k_sh}, vst{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, b, s, hq, hkv, hd, qst, kst, vst, causal,
                                        window, scale, st)
              : dispatch<float>(q, k, v, out, b, s, hq, hkv, hd, qst, kst, vst, causal, window,
                                scale, st);
  return static_cast<int>(rc);
}
