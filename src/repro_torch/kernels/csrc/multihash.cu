// Fused K-hash kernel for the integer Multilinear families
// (multilinear, multilinear_2x2, multilinear_hm) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/multihash.py::_multihash_kernel
// (launched by multihash_blocks). Computes, for every row b and function k:
//   acc = m1[k] + sum_i key[k][i] * tok_eff[b][i]      (mod 2^64)
//   HM:  acc = m1[k] + sum_p (key[k][2p] + s[2p]) * (key[k][2p+1] + s[2p+1])
// with the length-code mask and the append-1 sentinel applied in registers,
// then writes slots (acc >> 32, acc & 0xFFFFFFFF), or with mod_m != 0
// (acc % mod_m, acc >> 32), as int64 values into out (B, K, 2).
//
// What bounds it: each token is read from device memory once for all K
// functions (4 bytes) and costs K 64x32-bit multiply-adds (two 32-bit IMADs
// each); at K = 9 the card's integer instruction rate and its memory rate give
// bounds of the same order, so it sits near the bytes/operations ridge.
// Design: one block owns MH_ROWS rows and the whole column loop (blocks run
// in no order, so nothing is carried between them). Threads stride over the
// columns, so each warp's token and key loads are coalesced; the (K, W) key
// rows are read once per block for all MH_ROWS rows (and stay in L1/L2
// across blocks). K is looped in register chunks of MH_K_CHUNK, so any
// K >= 1 works; chunks after the first re-read the block's tokens from
// L1/L2, not from device memory. The per-thread sums are reduced with warp
// shuffles and then shared memory; + mod 2^64 is exact in any order, so the
// result is bit-identical to the plain version. Everything is uint64_t:
// signed overflow would be undefined behaviour. One u64 multiply-add per
// token replaces the reference's (hi, lo) limbs and 16-bit digit trick,
// which exist only because the TPU has no 64-bit lanes; native u64 % equals
// the reference's exact Barrett reduction.
#include "engine_common.cuh"

struct AddOp {
  __device__ __forceinline__ u64 operator()(u64 a, u64 b) const { return a + b; }
};

template <bool PAIRWISE>
__global__ void __launch_bounds__(MH_THREADS)
multihash_kernel(const u32* __restrict__ tokens, const u64* __restrict__ keys,
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
      // Dead key lanes need no mask here: tok_eff is already 0 there.
      for (int c = threadIdx.x; c < W; c += MH_THREADS) {
        u64 key[MH_K_CHUNK];
#pragma unroll
        for (int kk = 0; kk < MH_K_CHUNK; ++kk)
          key[kk] = kk < kn ? kbase[(size_t)kk * ldk + c] : 0ull;
#pragma unroll
        for (int r = 0; r < MH_ROWS; ++r) {
          const u64 t = tok_at(rc[r], c, N);
#pragma unroll
          for (int kk = 0; kk < MH_K_CHUNK; ++kk)
            if (kk < kn) acc[r][kk] += key[kk] * t;
        }
      }
    } else {
      // HM: thread owns lane pairs (2p, 2p+1); kend is even, so both lanes
      // of a pair are live or both dead, and a dead pair adds (0+0)*(0+0).
      for (int c = 2 * threadIdx.x; c < W; c += 2 * MH_THREADS) {
        u64 ka[MH_K_CHUNK], kb[MH_K_CHUNK];
#pragma unroll
        for (int kk = 0; kk < MH_K_CHUNK; ++kk) {
          ka[kk] = kk < kn ? kbase[(size_t)kk * ldk + c] : 0ull;
          kb[kk] = kk < kn ? kbase[(size_t)kk * ldk + c + 1] : 0ull;
        }
#pragma unroll
        for (int r = 0; r < MH_ROWS; ++r) {
          const bool live = c < rc[r].kend;
          const u64 s0 = tok_at(rc[r], c, N), s1 = tok_at(rc[r], c + 1, N);
#pragma unroll
          for (int kk = 0; kk < MH_K_CHUNK; ++kk)
            if (kk < kn && live) acc[r][kk] += (ka[kk] + s0) * (kb[kk] + s1);
        }
      }
    }

    u64 total = 0;
    block_reduce(acc, part, &total, AddOp());
    if (threadIdx.x < MH_ROWS * MH_K_CHUNK) {
      const int r = threadIdx.x / MH_K_CHUNK, kk = threadIdx.x % MH_K_CHUNK;
      const int b = row0 + r;
      if (b < B && kk < kn) {
        const int k = k0 + kk;
        const u64 h = total + keys[(size_t)k * ldk];  // + m1
        long long* o = out + ((size_t)b * K + k) * 2;
        if (mod_m) {
          o[0] = (long long)(h % mod_m);
          o[1] = (long long)(h >> 32);
        } else {
          o[0] = (long long)(h >> 32);
          o[1] = (long long)(h & 0xffffffffull);
        }
      }
    }
  }
}

extern "C" int repro_multihash(const void* tokens, const void* keys,
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
    multihash_kernel<true><<<grid, MH_THREADS, 0, s>>>(t, k, l, o, B, N, W, K, ldk, mod_m);
  else
    multihash_kernel<false><<<grid, MH_THREADS, 0, s>>>(t, k, l, o, B, N, W, K, ldk, mod_m);
  return (int)cudaGetLastError();
}
