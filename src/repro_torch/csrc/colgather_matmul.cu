// Column-gather back-projection for Hopper, one operand or two:
//   o1 = b1 @ Qt[idx, :]             (colgather_matmul)
//   o1, o2 = b1, b2 @ Qt[idx, :]     (colgather_matmul_dual)
// with b1, b2 (batch, m, r), Qt = Q^T (n, n) contiguous, idx (batch, r)
// int32 per layer, in three precisions. Replaces
// repro/kernels/colgather_matmul.py::_kernel and ::_kernel_dual (fp32, and
// bf16 with cast=bfloat16) and ::_kernel_q8 and ::_kernel_dual_q8 (int8);
// each is one template instantiated for one and for two operands.
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
// bf16 is the fp32 kernel with b and the gathered rows rounded to bf16
// (nearest even) as they are loaded, then multiplied and added in fp32
// (each product exact), so it differs from an fp32 product of the rounded
// operands only by the order of the sums.
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

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;

// at least 2 CTAs per SM: the prefetch registers of the dual instance would
// otherwise leave one
template <int kOps, bool kBf16>
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
      n1[t] = ok ? operand<kBf16>(b1[off]) : 0.f;
      if constexpr (kOps == 2) n2[t] = ok ? operand<kBf16>(b2[off]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kLoadsB; ++t) {
      const int e = tid + t * kThreads;
      const int k = k0 + e / BN, col = col0 + e % BN;
      float v = 0.f;
      if (k < r && col < n) {
        const int src = idx_b[k];
        if (src >= 0 && src < n)
          v = operand<kBf16>(qt[static_cast<long long>(src) * n + col]);
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

}  // namespace

namespace {

dim3 gather_grid(int batch, int m, int n) {
  return dim3((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
}

template <int kOps, bool kBf16>
int gather(const float* b1, const float* b2, const float* qt, const int* idx, float* o1,
           float* o2, int batch, int m, int r, int n, void* stream) {
  if (batch > 0 && m > 0 && n > 0)
    colgather_matmul_kernel<kOps, kBf16>
        <<<gather_grid(batch, m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            b1, b2, qt, idx, o1, o2, m, r, n);
  return static_cast<int>(cudaGetLastError());
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
  return gather<2, false>(b1, b2, qt, idx, o1, o2, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul(const float* b, const float* qt, const int* idx,
                                      float* o, int batch, int m, int r, int n,
                                      void* stream) {
  return gather<1, false>(b, nullptr, qt, idx, o, nullptr, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul_dual_bf16(const float* b1, const float* b2,
                                                const float* qt, const int* idx, float* o1,
                                                float* o2, int batch, int m, int r, int n,
                                                void* stream) {
  return gather<2, true>(b1, b2, qt, idx, o1, o2, batch, m, r, n, stream);
}

extern "C" int repro_colgather_matmul_bf16(const float* b, const float* qt, const int* idx,
                                           float* o, int batch, int m, int r, int n,
                                           void* stream) {
  return gather<1, true>(b, nullptr, qt, idx, o, nullptr, batch, m, r, n, stream);
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
