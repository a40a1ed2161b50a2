// Fused K-hash kernel for the carry-less GF(2^32) Multilinear families
// (gf_multilinear, gf_multilinear_hm) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/gf_multihash.py::_gf_multihash_kernel (with _clmul_tile and
// _xor_reduce_tile, launched by gf_multihash_blocks). Computes, for every
// row b and function k, with 32-bit keys (the low half of each u64 key):
//   acc = m1_lo[k] ^ xor_i clmul(key[k][i], tok_eff[b][i])
//   HM:  acc = m1_lo[k] ^ xor_p clmul(key[k][2p] ^ s[2p], key[k][2p+1] ^ s[2p+1])
// (63-bit accumulator), h32 = acc mod p(x) by Barrett with
// p = x^32 + x^7 + x^6 + x^2 + 1 (POLY_LOW 0xC5), then writes slots
// (h32, acc >> 32), or with mod_m != 0 (((h32 << 32) | acc_hi) % mod_m, h32),
// as int64 values into out (B, K, 2).
//
// What bounds it: operations. Hopper has no carry-less multiply, so each
// 32x32 -> 63-bit product is 32 shift-mask-xor steps on a u64, about 32x
// the work per token of the integer kernel, far above what the bytes (one
// 4-byte token read for all K) cost. Design: the same block layout as
// multihash.cu (a block owns MH_ROWS rows and the whole column loop, threads
// stride over columns, keys read once per block for all its rows, K in
// register chunks); the product is the reference's partial-product planes
// done bit-serially in registers; xor is exact in any order, so the warp
// shuffle + shared-memory reduction is bit-identical to the plain version.
// Window tables and an int8 tensor-core form of the planes are for later.
#include "engine_common.cuh"

#define GF_POLY_LOW 0xC5u

struct XorOp {
  __device__ __forceinline__ u64 operator()(u64 a, u64 b) const { return a ^ b; }
};

// Product with the 33-bit p = 2^32 + POLY_LOW; a < 2^31 here.
__device__ __forceinline__ u64 clmul_poly(u64 a) {
  return clmul32((u32)a, GF_POLY_LOW) ^ (a << 32);
}

// 63-bit carry-less accumulator mod p(x) (paper Appendix B, Knezevic et al.).
__device__ __forceinline__ u32 barrett(u64 acc) {
  const u64 q3 = clmul_poly(acc >> 32) >> 32;
  return (u32)((acc ^ clmul_poly(q3)) & 0xffffffffull);
}

template <bool PAIRWISE>
__global__ void __launch_bounds__(MH_THREADS)
gf_multihash_kernel(const u32* __restrict__ tokens, const u64* __restrict__ keys,
                    const int* __restrict__ lens, long long* __restrict__ out,
                    int B, int N, int W, int K, long long ldk, u64 mod_m) {
  __shared__ u64 part[MH_THREADS / 32][MH_ROWS][MH_K_CHUNK];
  const int row0 = blockIdx.x * MH_ROWS;
  RowCode rc[MH_ROWS];
#pragma unroll
  for (int r = 0; r < MH_ROWS; ++r) rc[r] = row_code(tokens, lens, row0 + r, B, N);

  for (int k0 = 0; k0 < K; k0 += MH_K_CHUNK) {
    const int kn = min(MH_K_CHUNK, K - k0);
    const u64* kbase = keys + (size_t)k0 * ldk + 1;  // column 0 is m1
    u64 acc[MH_ROWS][MH_K_CHUNK];
#pragma unroll
    for (int r = 0; r < MH_ROWS; ++r)
#pragma unroll
      for (int kk = 0; kk < MH_K_CHUNK; ++kk) acc[r][kk] = 0;

    if (!PAIRWISE) {
      // Dead key lanes need no mask: clmul(key, 0) = 0 and tok_eff is 0 there.
      for (int c = threadIdx.x; c < W; c += MH_THREADS) {
        u32 key[MH_K_CHUNK];
#pragma unroll
        for (int kk = 0; kk < MH_K_CHUNK; ++kk)
          key[kk] = kk < kn ? (u32)kbase[(size_t)kk * ldk + c] : 0u;
#pragma unroll
        for (int r = 0; r < MH_ROWS; ++r) {
          const u32 t = (u32)tok_at(rc[r], c, N);
#pragma unroll
          for (int kk = 0; kk < MH_K_CHUNK; ++kk)
            if (kk < kn) acc[r][kk] ^= clmul32(key[kk], t);
        }
      }
    } else {
      // HM lane pairs; a dead pair contributes clmul(0 ^ 0, 0 ^ 0) = 0.
      for (int c = 2 * threadIdx.x; c < W; c += 2 * MH_THREADS) {
        u32 ka[MH_K_CHUNK], kb[MH_K_CHUNK];
#pragma unroll
        for (int kk = 0; kk < MH_K_CHUNK; ++kk) {
          ka[kk] = kk < kn ? (u32)kbase[(size_t)kk * ldk + c] : 0u;
          kb[kk] = kk < kn ? (u32)kbase[(size_t)kk * ldk + c + 1] : 0u;
        }
#pragma unroll
        for (int r = 0; r < MH_ROWS; ++r) {
          const bool live = c < rc[r].kend;
          const u32 s0 = (u32)tok_at(rc[r], c, N), s1 = (u32)tok_at(rc[r], c + 1, N);
#pragma unroll
          for (int kk = 0; kk < MH_K_CHUNK; ++kk)
            if (kk < kn && live) acc[r][kk] ^= clmul32(ka[kk] ^ s0, kb[kk] ^ s1);
        }
      }
    }

    u64 total = 0;
    block_reduce(acc, part, &total, XorOp());
    if (threadIdx.x < MH_ROWS * MH_K_CHUNK) {
      const int r = threadIdx.x / MH_K_CHUNK, kk = threadIdx.x % MH_K_CHUNK;
      const int b = row0 + r;
      if (b < B && kk < kn) {
        const int k = k0 + kk;
        const u64 a = total ^ (keys[(size_t)k * ldk] & 0xffffffffull);  // m1 lo
        const u32 h32 = barrett(a);
        const u32 acc_hi = (u32)(a >> 32);
        long long* o = out + ((size_t)b * K + k) * 2;
        if (mod_m) {
          o[0] = (long long)((((u64)h32 << 32) | acc_hi) % mod_m);
          o[1] = (long long)h32;
        } else {
          o[0] = (long long)h32;
          o[1] = (long long)acc_hi;
        }
      }
    }
  }
}

extern "C" int repro_gf_multihash(const void* tokens, const void* keys,
                                  const void* lens, void* out, int B, int N,
                                  int W, int K, long long ldk, int pairwise,
                                  unsigned long long mod_m, void* stream) {
  const dim3 grid((B + MH_ROWS - 1) / MH_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  const u32* t = (const u32*)tokens;
  const u64* k = (const u64*)keys;
  const int* l = (const int*)lens;
  long long* o = (long long*)out;
  if (pairwise)
    gf_multihash_kernel<true><<<grid, MH_THREADS, 0, s>>>(t, k, l, o, B, N, W, K, ldk, mod_m);
  else
    gf_multihash_kernel<false><<<grid, MH_THREADS, 0, s>>>(t, k, l, o, B, N, W, K, ldk, mod_m);
  return (int)cudaGetLastError();
}
