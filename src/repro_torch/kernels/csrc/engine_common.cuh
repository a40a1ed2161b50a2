// Shared pieces of the hash kernels: the integer types and the bit-serial
// carry-less product that gf_multilinear.cu and the HM pair term of
// gf_multihash.cu use.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef uint64_t u64;
typedef uint32_t u32;

// Carry-less 32x32 -> 63-bit product: plane i is a << i, gated by bit i of b.
__device__ __forceinline__ u64 clmul32(u32 a, u32 b) {
  const u64 wa = a;
  u64 r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) r ^= (wa << i) & (0ull - (u64)((b >> i) & 1u));
  return r;
}
