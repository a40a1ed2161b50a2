// Single-hash kernel for the carry-less GF(2^32) Multilinear families
// (gf_multilinear, gf_multilinear_hm) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/gf_multilinear.py::_gf_kernel
// and _gf_hm_kernel (launched by gf_hash_blocks), and fuses in the finish
// that the reference's gf_hash runs after them. Computes, for every row b
// of B fixed-length rows of N u32 tokens and N u32 keys k, the raw 63-bit
// carry-less accumulator
//   acc[b] = xor_i clmul(k[i], s[b][i])
//   HM:      xor_p clmul(k[2p] ^ s[b][2p], k[2p+1] ^ s[b][2p+1])
// over floor(N / 2) pairs, and writes either (acc >> 32, acc & 0xFFFFFFFF)
// as int64 values into out (B, 2), or, with `finish` (keys then hold m1
// first and the N positional keys after it), the hash Barrett(acc ^ m1)
// mod p(x) with p = x^32 + x^7 + x^6 + x^2 + 1 into out (B,).
//
// What bounds it: Hopper has no carry-less multiply. Done bit-serially a
// 32x32 -> 63-bit product is 32 shift-mask-xor steps on a u64, ~190 integer
// operations a token against its 4 bytes, 10x the memory time. Design
// (gf_single.cuh): the plain family's sum is a GF(2) matrix product of the
// rows' token bits by Toeplitz matrices of the key bits, which the b1
// tensor cores count with AND and popc (mma m16n8k256, the parity of a count
// is the GF(2) sum); the HM family's pair product, whose two factors both
// carry a token, takes 16 integer multiplies with holes in place of the 32
// steps; the column split keeps the card busy for a few long rows, and the
// m1 xor and Barrett run in the pass that writes a row.
#include "gf_single.cuh"

extern "C" int repro_gf_multilinear(const void* tokens, const void* keys,
                                    void* part, void* out, int B, int N,
                                    int pairwise, int finish, int split,
                                    void* stream) {
  return launch_gf_single(tokens, keys, part, out, B, N, pairwise, finish,
                          split, stream);
}

// Launches gf_b1_rate on `blocks` blocks of GS_THREADS threads (sink holds
// blocks x GS_THREADS int); returns cudaGetLastError().
extern "C" int repro_gf_multilinear_b1_rate(int blocks, int iters, void* sink,
                                            void* stream) {
  gf_b1_rate<<<blocks, GS_THREADS, 0, (cudaStream_t)stream>>>(iters, (int*)sink);
  return (int)cudaGetLastError();
}
