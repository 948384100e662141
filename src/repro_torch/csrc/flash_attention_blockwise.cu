// The model's dense attention on Hopper's tensor cores: the bf16 prefill's
// route (kernels/flash_attention.py::flash_attention_blockwise).
//
// Replaces, on the model's path, repro/kernels/flash_attention.py::_kernel,
// but computes the function the JAX model's prefill runs, its
// models/layers.py::blockwise_attention, and not the TPU kernel's:
//   * s = (q . k) with bf16 products summed in fp32 (mma.sync), times
//     scale = 1 / sqrt(hd) rounded to fp32 (PyTorch's division by a scalar
//     on the card); masked scores (causal: key > query; window: query -
//     key >= window; a key past Skv or past the chunk) are -1e30;
//   * the running max m is taken once per kv chunk of `chunk` keys (the
//     wrapper resolves the model's rule on the keys' length: min(kv_chunk,
//     Skv), or Skv when Skv is not a multiple of it), not per tile: m_new =
//     max(m, max of the chunk's scores);
//   * p = expf(s - m_new) in fp32 (the accurate expf); l sums the fp32 p;
//     P is rounded to bf16 before P . V, which sums in fp32;
//   * the accumulator and l are rescaled by expf(m - m_new) once per chunk;
//     O = acc / max(l, 1e-30), rounded to bf16.
// A row whose whole chunk is masked gets p = 1 there, as in JAX; the next
// chunk's expf(-1e30 - m) = 0 wipes it. So chunks and 64-key tiles that are
// masked for every row of a block are skipped (a causal row's own chunk
// always holds its diagonal), and the garbage of a skipped tile in a
// fully masked chunk is wiped all the same. Skipping a tile inside a chunk
// leaves the chunk's max unchanged.
//
// Keys of their own length (Skv != Sq: a cross-attention's queries against
// an image's 6400 patch embeddings, one chunk of 6400) come without a mask.
// A query slice at an offset (sequence-parallel attention: rank i's rows
// [q_offset, q_offset + Sq) of a prefill against all of its keys) comes
// with any mask: query row r is absolute position q_offset + r, the masks,
// the causal bound hi and the window's lo compare absolute positions, and
// the kv chunks stay aligned at key 0, so a row sees the chunks it sees in
// the whole prefill. Under a mask the keys cover the slice (Skv >= q_offset
// + Sq).
//
// Bound: operations. 4 * hd flops per unmasked (query, key) pair against
// 2 * hd K/V bytes that a tile shares among 64 queries.
//
// Design:
//   * One CTA of 4 warps per (block of 64 query rows, q head, batch row),
//     blocks with the longest walks issued first; each warp owns 16 rows.
//     GQA by the index map (kv head h / group); q, k, v read through their
//     strides (rows on 16 bytes, the wrapper checks).
//   * Q is loaded once; for hd <= 128 each warp holds it as m16n8k16 A
//     fragments in registers (ldmatrix); above, registers go to the
//     accumulator and Q fragments are read from shared memory per step.
//   * K/V tiles of 64 keys arrive by cp.async (16 bytes a thread, rows past
//     Skv and dims past hd zero-filled) into a ring of slots of two tiles, 3
//     slots for hd <= 64 (three CTAs still fit an SM) and 2 above: the next
//     steps load while this one computes. Rows are padded by 16 bytes so
//     ldmatrix reads them without bank conflicts.
//   * The max per chunk: for each chunk, pass 0 walks its tiles two at a
//     time (two K tiles in a slot) and computes only S and its row max;
//     pass 1 walks them one at a time (a K and a V tile in a slot),
//     recomputes S (bit-identical: the same instructions on the same
//     data), then p, l and P . V. The
//     recompute costs 1.5x the tensor-core work of one pass. Keeping the
//     chunk's fp32 S in shared memory instead would need 64 x 1024 x 4 =
//     256 KB for gemma3's chunk, more than an SM has, so this recomputes.
//   * P goes from the S accumulators straight into the A fragments of the
//     P . V mma, rounded to bf16 in pairs; V's B fragments come through
//     ldmatrix.trans. The accumulator stays in registers for the walk.
//   * Row max and sum across the 4 lanes that share a row by shuffles; l is
//     kept per lane and summed once at the end. No atomics and a fixed
//     order, so two launches are bit-identical.
//   * Any hd that is a multiple of 16 up to 256, padded to a multiple of 32
//     in shared memory (zero dims add exact zeros).
//   * Values of their own head dim vd (MLA: q and k of 192, v of 128), also
//     a multiple of 16 up to 256: the tiles are laid out at the wider of
//     the two (HDP = max(hd, vd) rounded up to 32), Q and K rows filled to
//     hd and V rows to vd, the rest zero. The k-steps of Q K^T past hd and
//     the 16-wide dim tiles of P V past vd are skipped (a warp-uniform
//     test), so a narrower side costs no tensor-core work; the output is
//     (B, S, Hq, vd).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The walk of one CTA over the keys [lo, hi) that hold an unmasked pair
// for some row of its block: for each kv chunk, pass 0 over its tiles two
// at a time (a ring slot holds two K tiles, or one K and one V tile), then
// pass 1 over the same tiles one at a time.
struct Walk {
  int chunk, pass, tile;
  int lo, hi, len;  // the block's keys, the chunk length

  __device__ int begin() const { return max(chunk * len, lo); }
  __device__ int tiles() const {
    return (min((chunk + 1) * len, hi) - begin() + kBK - 1) / kBK;
  }
  __device__ int key0() const { return begin() + tile * kBK; }
  // pass 0 holds a second K tile in the slot's other half
  __device__ bool pair() const { return pass == 0 && tile + 1 < tiles(); }
  __device__ bool last_step() const { return tile + (pass == 0 ? 2 : 1) >= tiles(); }
  __device__ void advance() {
    const bool last = last_step();
    tile += pass == 0 ? 2 : 1;
    if (!last) return;
    tile = 0;
    if (pass == 0) {
      pass = 1;
    } else {
      pass = 0;
      ++chunk;
    }
  }
};

template <int HDP>
struct Tile {
  static constexpr int kLd = HDP + 8;        // shared row stride (bf16)
  static constexpr int kPieces = HDP / 8;    // 16-byte pieces per row
  static constexpr int kKSteps = HDP / 16;   // k-steps of Q K^T
  static constexpr int kDTiles = HDP / 8;    // 8-wide dim tiles of O
  static constexpr bool kQRegs = HDP <= 128;
  // ring slots of two 64-key tiles: 3 where three CTAs still fit an SM
  static constexpr int kStages = HDP <= 64 ? 3 : 2;
  static constexpr int kMinBlocks = HDP <= 64 ? 3 : 2;
  static constexpr size_t kSmem = sizeof(bf16) * (kBQ + 2 * kStages * kBK) * kLd;
};

// rows [r0, r0 + 64) of one head into dst[64][kLd]; rows >= s and dims >= hd
// zero-filled
template <int HDP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int r0,
                                          int s, int hd) {
  using T = Tile<HDP>;
#pragma unroll
  for (int i = 0; i < kBK * T::kPieces / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / T::kPieces, c = e % T::kPieces;
    const bool ok = r0 + r < s && c * 8 < hd;
    const bf16* from = ok ? src + static_cast<long long>(r0 + r) * stride + c * 8 : src;
    mma::cp_async16(dst + r * T::kLd + c * 8, from, ok);
  }
}

// One warp's scores of a 64-key tile, scaled and masked: sc[j][e] is row
// rows[e / 2], key key0 + 8 j + 2 t + e % 2 (the m16n8 C layout). The
// k-steps past hd hold zeros in both operands and are skipped.
template <int HDP>
__device__ __forceinline__ void tile_scores(float (&sc)[8][4], const unsigned (*qf)[4],
                                            const bf16* q_frag, const bf16* ks, int key0,
                                            int kstop, int row_w, const int (&rows)[2],
                                            int causal, int window, float scale, int hd) {
  using T = Tile<HDP>;
  constexpr int kLd = T::kLd;
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < T::kKSteps; ++kk) {
    if (kk * 16 >= hd) continue;
    unsigned a[4];
    if constexpr (T::kQRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
    } else {
      mma::ldmatrix_x4(a, q_frag + kk * 16);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned kb[4];
      mma::ldmatrix_x4(kb, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd + kk * 16 +
                               ((lane >> 3) & 1) * 8);
      mma::mma_bf16(sc[2 * np], a, kb[0], kb[1]);
      mma::mma_bf16(sc[2 * np + 1], a, kb[2], kb[3]);
    }
  }
  // mask only where some key of the tile may be masked for some row of the
  // warp (a warp-uniform test)
  const bool need_mask = key0 + kBK > kstop || (causal && key0 + kBK - 1 > row_w) ||
                         (window > 0 && key0 <= row_w + 15 - window);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[j][e] * scale;
      if (need_mask) {
        const int row = rows[e >> 1], key = key0 + 8 * j + 2 * t + (e & 1);
        bool ok = key < kstop;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && row - key < window;
        x = ok ? x : kNegInf;
      }
      sc[j][e] = x;
    }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, Tile<HDP>::kMinBlocks)
flash_attention_blockwise_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out, int s, int skv,
                              int hq, int group, int hd, int vd, Strides qst, Strides kst,
                              Strides vst, int causal, int window, int chunk, int q_offset,
                              float scale) {
  using T = Tile<HDP>;
  constexpr int kLd = T::kLd;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][kLd]
  bf16* ring = qs + kBQ * kLd;                    // [kStages][2][kBK][kLd]

  const int qblock = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qblock * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  // absolute positions: the masks and the walk's bounds compare these
  const int row_w = q_offset + q0 + warp * 16;  // the warp's first row
  const int rows[2] = {row_w + (lane >> 2), row_w + (lane >> 2) + 8};
  const int hk = h / group;
  const bf16* qp = q + b * qst.b + h * qst.h;
  const bf16* kp = k + b * kst.b + hk * kst.h;
  const bf16* vp = v + b * vst.b + hk * vst.h;

  const int q_last = q_offset + min(q0 + kBQ, s) - 1;
  const int hi = causal ? q_last + 1 : skv;
  const int lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int last_chunk = (hi - 1) / chunk;
  Walk prod{lo / chunk, 0, 0, lo, hi, chunk};
  Walk cons = prod;

  // a step's slot: K tile, then the second K tile (pass 0) or the V tile
  auto issue = [&](const Walk& w, int slot) {
    bf16* ks = ring + slot * 2 * kBK * kLd;
    load_rows<HDP>(ks, kp, kst.s, w.key0(), skv, hd);
    if (w.pass == 1)
      load_rows<HDP>(ks + kBK * kLd, vp, vst.s, w.key0(), skv, vd);
    else if (w.pair())
      load_rows<HDP>(ks + kBK * kLd, kp, kst.s, w.key0() + kBK, skv, hd);
  };

  load_rows<HDP>(qs, qp, qst.s, q0, s, hd);
  mma::cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (prod.chunk <= last_chunk) {
      issue(prod, st);
      prod.advance();
    }
    mma::cp_async_commit();
  }

  unsigned qf[T::kQRegs ? T::kKSteps : 1][4];
  float acc[T::kDTiles][4];
#pragma unroll
  for (int j = 0; j < T::kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, cmax[2] = {kNegInf, kNegInf};
  const bf16* q_frag = qs + (warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;

  for (int step = 0; cons.chunk <= last_chunk; ++step) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tiles have landed; the last step's reads are done
    if (prod.chunk <= last_chunk) {
      issue(prod, (step + kStages - 1) % kStages);
      prod.advance();
    }
    mma::cp_async_commit();
    if constexpr (T::kQRegs) {
      if (step == 0) {
#pragma unroll
        for (int kk = 0; kk < T::kKSteps; ++kk) mma::ldmatrix_x4(qf[kk], q_frag + kk * 16);
      }
    }
    const bf16* ks = ring + (step % kStages) * 2 * kBK * kLd;
    const int key0 = cons.key0();
    const int kstop = min((cons.chunk + 1) * chunk, skv);
    float sc[8][4];

    if (cons.pass == 0) {
      // the chunk's row max over one or two tiles; at its last step,
      // rescale by expf(m - m_new)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 1 && !cons.pair()) break;
        tile_scores<HDP>(sc, qf, q_frag, ks + half * kBK * kLd, key0 + half * kBK, kstop,
                         row_w, rows, causal, window, scale, hd);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cmax[e >> 1] = fmaxf(cmax[e >> 1], sc[j][e]);
      }
      if (cons.last_step()) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], quad_max(cmax[i]));
          const float corr = expf(m[i] - m_new);
          l[i] *= corr;
#pragma unroll
          for (int j = 0; j < T::kDTiles; ++j) {
            acc[j][2 * i] *= corr;
            acc[j][2 * i + 1] *= corr;
          }
          m[i] = m_new;
          cmax[i] = kNegInf;
        }
      }
    } else {
      // recompute S; p in fp32 into l, P rounded to bf16 into the A
      // fragments of P . V
      tile_scores<HDP>(sc, qf, q_frag, ks, key0, kstop, row_w, rows, causal, window, scale, hd);
      const bf16* vs = ks + kBK * kLd;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        unsigned a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const float p0 = expf(sc[j][0] - m[0]), p1 = expf(sc[j][1] - m[0]);
          const float p2 = expf(sc[j][2] - m[1]), p3 = expf(sc[j][3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          a[2 * half] = mma::pack_bf16(p0, p1);
          a[2 * half + 1] = mma::pack_bf16(p2, p3);
        }
#pragma unroll
        for (int dp = 0; dp < T::kDTiles / 2; ++dp) {
          if (dp * 16 >= vd) continue;
          unsigned vb[4];
          mma::ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * kLd + dp * 16 + (lane >> 4) * 8);
          mma::mma_bf16(acc[2 * dp], a, vb[0], vb[1]);
          mma::mma_bf16(acc[2 * dp + 1], a, vb[2], vb[3]);
        }
      }
    }
    cons.advance();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    const int row = rows[i] - q_offset;  // the slice's own row
    if (row >= s) continue;
    bf16* o = out + ((static_cast<long long>(b) * s + row) * hq + h) * vd;
#pragma unroll
    for (int j = 0; j < T::kDTiles; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < vd)
        *reinterpret_cast<unsigned*>(o + d) =
            mma::pack_bf16(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    }
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int s, int skv,
                   int hq, int hkv, int hd, int vd, Strides qst, Strides kst, Strides vst,
                   int causal, int window, int chunk, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<HDP>::kSmem;
  static_assert(smem <= 227 * 1024, "tiles exceed shared memory");
  auto kernel = flash_attention_blockwise_fwd<HDP>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ), static_cast<unsigned>(hq),
                  static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), s, skv, hq, hq / hkv, hd, vd, qst, kst, vst, causal, window,
      chunk, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, Hq, hd), k (B, Skv, Hkv, hd), v (B, Skv, Hkv, vd) bf16 with the
// given element strides of the batch, sequence and head axes (the head dim
// contiguous, every row on 16 bytes); out (B, S, Hq, vd) contiguous bf16.
// hd and vd multiples of 16 up to 256; window <= 0 means none; q_offset
// >= 0 the absolute position of q's first row; under a mask the keys
// cover the rows (Skv >= q_offset + S); chunk: the model's effective
// kv chunk of Skv keys (>= 1); sqrt_hd: sqrt(hd) rounded to fp32,
// whose fp32 reciprocal scales the scores. The caller checks the grid
// limits (Hq, B < 65536).
extern "C" int repro_flash_attention_blockwise(
    const void* q, const void* k, const void* v, void* out, int b, int s, int skv, int hq,
    int hkv, int hd, int vd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal,
    int window, int q_offset, int chunk, float sqrt_hd, void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  const bool masked = causal || window > 0;
  if (skv <= 0 || hkv <= 0 || hq % hkv || hd <= 0 || hd % 16 || hd > 256 || vd <= 0 ||
      vd % 16 || vd > 256 || chunk <= 0 || q_offset < 0 ||
      (masked && skv < q_offset + s))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qst{q_sb, q_ss, q_sh}, kst{k_sb, k_ss, k_sh}, vst{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrt_hd;
#define REPRO_FA_CASE(n)                                                                   \
  case n:                                                                                  \
    return static_cast<int>(launch<32 * n>(q, k, v, out, b, s, skv, hq, hkv, hd, vd, qst, kst, \
                                           vst, causal, window, chunk, q_offset, scale, st));
  switch (((hd > vd ? hd : vd) + 31) / 32) {
    REPRO_FA_CASE(1)
    REPRO_FA_CASE(2)
    REPRO_FA_CASE(3)
    REPRO_FA_CASE(4)
    REPRO_FA_CASE(5)
    REPRO_FA_CASE(6)
    REPRO_FA_CASE(7)
    default:
      return static_cast<int>(launch<256>(q, k, v, out, b, s, skv, hq, hkv, hd, vd, qst, kst,
                                          vst, causal, window, chunk, q_offset, scale, st));
  }
#undef REPRO_FA_CASE
}
