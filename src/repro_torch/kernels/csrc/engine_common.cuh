// Shared pieces of the hash kernels: the fused multi-hash engine's launch
// constants, length-code algebra and block-wide reduction (multihash.cu,
// gf_multihash.cu), and the carry-less product that gf_multihash.cu and
// gf_multilinear.cu both use.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MH_THREADS
#define MH_THREADS 128
#endif
#ifndef MH_ROWS
#define MH_ROWS 4
#endif
#ifndef MH_K_CHUNK
#define MH_K_CHUNK 8
#endif

static_assert(MH_THREADS % 32 == 0, "whole warps only");
static_assert(MH_THREADS >= MH_ROWS * MH_K_CHUNK,
              "one thread finishes each (row, hash) of a chunk");

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

// Length code of one row (repro/kernels/multihash.py::_mask_tile):
// code >= 0 is a variable-length row of `code` tokens with the sentinel 1 at
// position lm = code; code < 0 a fixed-length row of lm = -code-1 tokens.
// Key lanes at or past kend = even(lm + is_var) are dead.
struct RowCode {
  const u32* tok;  // the row's tokens (N of them)
  int lm;
  int kend;
  bool is_var;
};

__device__ __forceinline__ RowCode row_code(const u32* tokens, const int* lens,
                                            int b, int B, int N) {
  RowCode rc;
  if (b >= B) {  // past the batch: a dead fixed-length row, never written
    rc.tok = tokens;
    rc.lm = 0;
    rc.kend = 0;
    rc.is_var = false;
    return rc;
  }
  const int code = lens[b];
  rc.tok = tokens + (size_t)b * N;
  rc.is_var = code >= 0;
  rc.lm = rc.is_var ? code : -code - 1;
  const int end = rc.lm + (rc.is_var ? 1 : 0);
  rc.kend = end + (end & 1);
  return rc;
}

// Masked token at column c: the token before lm (0 past the N real
// columns), the sentinel 1 at lm on variable-length rows, else 0.
__device__ __forceinline__ u64 tok_at(const RowCode& rc, int c, int N) {
  if (c < rc.lm) return c < N ? (u64)rc.tok[c] : 0ull;
  return (rc.is_var && c == rc.lm) ? 1ull : 0ull;
}

// Block-wide reduction of acc[MH_ROWS][MH_K_CHUNK] with an exact,
// order-free operation (+ mod 2^64 or xor): warp shuffles, then one
// shared-memory slot per warp. On return thread t < MH_ROWS*MH_K_CHUNK
// holds the total of (row t / MH_K_CHUNK, hash t % MH_K_CHUNK) in *total.
template <typename Op>
__device__ __forceinline__ void block_reduce(
    u64 (&acc)[MH_ROWS][MH_K_CHUNK],
    u64 (&part)[MH_THREADS / 32][MH_ROWS][MH_K_CHUNK], u64* total, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < MH_ROWS; ++r) {
#pragma unroll
    for (int kk = 0; kk < MH_K_CHUNK; ++kk) {
      u64 v = acc[r][kk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = op(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) part[warp][r][kk] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < MH_ROWS * MH_K_CHUNK) {
    const int r = threadIdx.x / MH_K_CHUNK, kk = threadIdx.x % MH_K_CHUNK;
    u64 s = part[0][r][kk];
#pragma unroll
    for (int w = 1; w < MH_THREADS / 32; ++w) s = op(s, part[w][r][kk]);
    *total = s;
  }
  __syncthreads();  // `part` is reused by the next chunk of hashes
}
