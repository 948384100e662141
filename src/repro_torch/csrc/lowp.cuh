// Helpers of the int8 kernels of dct_project.cu and colgather_matmul.cu.
#pragma once

#include <cstdint>

// int8: four codes of consecutive k are packed in one 32-bit word, byte i
// holding offset i, the layout __dp4a multiplies.
namespace q8 {

// The codes p[0..3] as one word; those at offsets >= limit read as 0 (and
// are not touched). `vec`: p is 4-byte aligned whenever limit >= 4 (a row
// stride that is a multiple of 4), so one 32-bit load does.
__device__ __forceinline__ int load4(const int8_t* p, int limit, bool vec) {
  if (limit <= 0) return 0;
  if (vec && limit >= 4) return *reinterpret_cast<const int*>(p);
  unsigned w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < limit) w |= static_cast<unsigned>(static_cast<uint8_t>(p[i])) << (8 * i);
  return static_cast<int>(w);
}

// 4x4 byte transpose: r[i] holds the codes of row k + i at columns c..c+3;
// the result's word j holds the codes of column c + j at rows k..k+3.
__device__ __forceinline__ int4 transpose4(const int r[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  return make_int4(static_cast<int>(__byte_perm(t0, t2, 0x5410)),
                   static_cast<int>(__byte_perm(t0, t2, 0x7632)),
                   static_cast<int>(__byte_perm(t1, t3, 0x5410)),
                   static_cast<int>(__byte_perm(t1, t3, 0x7632)));
}

}  // namespace q8
