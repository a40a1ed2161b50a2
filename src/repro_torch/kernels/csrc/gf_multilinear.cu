// Single-hash kernel for the carry-less GF(2^32) Multilinear families
// (gf_multilinear, gf_multilinear_hm) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/gf_multilinear.py::_gf_kernel
// and _gf_hm_kernel (launched by gf_hash_blocks). Computes, for every row b
// of B fixed-length rows of N u32 tokens and N u32 keys k (m1 excluded),
// the raw 63-bit carry-less accumulator
//   acc[b] = xor_i clmul(k[i], s[b][i])
//   HM:      xor_p clmul(k[2p] ^ s[b][2p], k[2p+1] ^ s[b][2p+1])
// over floor(N / 2) pairs, and writes (acc >> 32, acc & 0xFFFFFFFF) as int64
// values into out (B, 2). The wrapper xors m1 in and reduces mod p(x)
// (Barrett).
//
// What bounds it: operations. Hopper has no carry-less multiply, so each
// 32x32 -> 63-bit product is 32 shift-mask-xor steps on a u64 (clmul32 in
// engine_common.cuh, shared with gf_multihash.cu), far more work per token
// than its 4 bytes cost. Design: the tiling of single_hash.cuh (column
// tiles x row groups, the tile's 32-bit keys staged in shared memory and
// reused across rows, a warp per row, partials combined by xor, which is
// exact in any order). Window tables and a tensor-core form come later.
#include "single_hash.cuh"

struct GfFamily {
  typedef u32 Key;
  static __device__ __forceinline__ u64 add(u64 a, u64 b) { return a ^ b; }
  static __device__ __forceinline__ u64 term(u32 k, u32 s) { return clmul32(k, s); }
  static __device__ __forceinline__ u64 pair(u32 k0, u32 k1, u32 s0, u32 s1) {
    return clmul32(k0 ^ s0, k1 ^ s1);
  }
};

extern "C" int repro_gf_multilinear(const void* tokens, const void* keys,
                                    void* part, void* out, int B, int N,
                                    int pairwise, void* stream) {
  return launch_single_hash<GfFamily>(tokens, keys, part, out, B, N,
                                      pairwise, stream);
}
