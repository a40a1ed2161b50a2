// Single-hash kernel for the integer Multilinear families (multilinear,
// multilinear_2x2, multilinear_hm) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/multilinear.py::
// _multilinear_kernel and _multilinear_hm_kernel (launched by hash_blocks).
// Computes, for every row b of B fixed-length rows of N u32 tokens and one
// key string k (N u64 keys, m1 excluded), the raw accumulator
//   acc[b] = sum_i k[i] * s[b][i]                               (mod 2^64)
//   HM:      sum_p (k[2p] + s[b][2p]) * (k[2p+1] + s[b][2p+1])  (mod 2^64)
// over floor(N / 2) pairs, and writes (acc >> 32, acc & 0xFFFFFFFF) as int64
// values into out (B, 2). multilinear_2x2 has the plain family's value and
// runs the plain variant. The wrapper adds m1 and takes >> 32.
//
// What bounds it: bytes. Each token is read once (4 bytes) for one 64x32-bit
// multiply-add (two 32-bit IMADs); the keys are read once per block from
// L2 into shared memory. Design (single_hash.cuh): column tiles x row
// groups, keys staged in shared memory and reused across the block's rows,
// a warp per row with coalesced token loads, and an exact combination of
// the column tiles' partials (+ mod 2^64 in any order). uint64_t
// throughout: the reference's (hi, lo) limbs and 16-bit digit trick exist
// only because the TPU has no 64-bit lanes, and signed overflow would be
// undefined behaviour in C++.
#include "single_hash.cuh"

struct IntFamily {
  typedef u64 Key;
  static __device__ __forceinline__ u64 add(u64 a, u64 b) { return a + b; }
  static __device__ __forceinline__ u64 term(u64 k, u32 s) { return k * (u64)s; }
  static __device__ __forceinline__ u64 pair(u64 k0, u64 k1, u32 s0, u32 s1) {
    return (k0 + s0) * (k1 + s1);
  }
};

extern "C" int repro_multilinear(const void* tokens, const void* keys,
                                 void* part, void* out, int B, int N,
                                 int pairwise, void* stream) {
  return launch_single_hash<IntFamily>(tokens, keys, part, out, B, N,
                                       pairwise, stream);
}
