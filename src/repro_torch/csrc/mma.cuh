// Tensor-core building blocks of the Hopper kernels (sm_90a): cp.async
// copies into shared memory, ldmatrix fragment loads, the bf16
// mma.sync.m16n8k16 and the TF32 mma.sync.m16n8k8 with fp32 accumulators,
// the int8 mma.sync.m16n8k32 with int32 accumulators,
// and the split of an fp32 value into the two TF32 parts of a 3xTF32
// product (about fp32's accuracy on the TF32 path).
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16: {row g, cols 2t..2t+1},
//     {row g + 8, cols 2t..}, {row g, cols 8 + 2t..}, {row g + 8, cols 8 + 2t..};
//   B (16 x 8), 2 registers: {k 2t..2t+1, col g}, {k 8 + 2t.., col g};
//   C (16 x 8, fp32): {row g, cols 2t, 2t + 1}, {row g + 8, cols 2t, 2t + 1}.
// So two C tiles side by side, rounded to bf16 in pairs, are the A fragment
// of the next product (FlashAttention-2's P . V without a trip through
// shared memory).
//
// m16n8k8 TF32 (one 32-bit register per element):
//   A (16 x 8), 4 registers: {row g, col t}, {row g + 8, col t},
//     {row g, col t + 4}, {row g + 8, col t + 4};
//   B (8 x 8), 2 registers: {k t, col g}, {k t + 4, col g};
//   C: as m16n8k16's.
// A C tile is therefore the A fragment of the next product once its k
// index is read as: k t <-> C column 2t, k t + 4 <-> column 2t + 1 (the B
// operand's rows are taken in that order too).
#pragma once

#include <cuda_bf16.h>

namespace mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled (nothing read) when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, register i receives matrix i (row g, elements 2t, 2t + 1)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed: register i holds rows 2t, 2t + 1 of
// column g of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: int8 operands, exact int32 sums (no
// saturation: the caller keeps every sum below 2^31). Fragments of
// m16n8k32, four int8 of consecutive k per register: A {row g, k 4t..4t+3},
// {row g + 8, k 4t..}, {row g, k 16 + 4t..}, {row g + 8, k 16 + 4t..} --
// byte for byte m16n8k16's bf16 layout, so ldmatrix_x4 loads it the same
// way; B {k 4t..4t+3, col g}, {k 16 + 4t.., col g}; C as m16n8k16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores: bf16 operands, exact products, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo for 3xTF32, in two instructions: hi is x itself, which the
// tensor cores read as x truncated to TF32 (they drop its low 13 bits);
// lo = x - trunc(x) (exact in fp32, |lo| < 2^-10 |x|), read truncated in
// turn, so hi + lo carries x to within 2^-20 |x|.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a . b on the tensor cores: TF32 operands, exact products, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even, as __float2bfloat16_rn
// each; a NaN stays NaN), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace mma
