// Shared tiling of the single-hash kernels (multilinear.cu,
// gf_multilinear.cu): one keyed hash of each of B fixed-length rows of N
// u32 tokens, as the raw accumulator (no m1, no finish; the wrapper adds
// them). A family F supplies the key type, the per-token term, the HM pair
// term and the combining operation (+ mod 2^64 or xor; both exact in any
// order, so every grid and reduction order gives the same bits).
//
// Grid: (S column tiles of SH_TILE, row groups of SH_ROWS). The shapes run
// from many short rows (B 65,536 x N 1,024) to a few long ones (B 64 x N
// 2^20), so a block owns one tile of columns for a group of rows; splitting
// the columns keeps the 132 SMs busy when B is small. The tile's keys are
// staged in shared memory once per block and reused by all of its rows.
// Each warp walks one row of the tile at a time: lanes stride over columns
// (coalesced token loads), then a warp shuffle combines the 32 lane sums.
// With S = 1 the warp writes the row's (hi, lo) directly; otherwise it
// writes its partial to part[b * S + tile] and a second pass (one warp per
// row) combines the S partials.
#pragma once

#include "engine_common.cuh"

#ifndef SH_THREADS
#define SH_THREADS 256
#endif
#ifndef SH_ROWS
#define SH_ROWS 32
#endif
#ifndef SH_TILE
#define SH_TILE 2048
#endif

static_assert(SH_THREADS % 32 == 0, "whole warps only");
static_assert(SH_TILE % 64 == 0, "HM pairs never straddle a tile");

template <class F>
__device__ __forceinline__ u64 warp_combine(u64 acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = F::add(acc, __shfl_down_sync(0xffffffffu, acc, off));
  return acc;
}

// out[b] = (acc >> 32, acc & 0xFFFFFFFF) as int64 values.
__device__ __forceinline__ void write_acc(long long* out, int b, u64 acc) {
  out[(size_t)b * 2] = (long long)(acc >> 32);
  out[(size_t)b * 2 + 1] = (long long)(acc & 0xffffffffull);
}

// cols: the hashed columns, N (plain) or 2 * floor(N / 2) (HM: the
// reference pads an odd row with a zero token and a zero key, so its last
// token pairs with zeros and adds nothing).
template <class F, bool PAIRWISE>
__global__ void __launch_bounds__(SH_THREADS)
single_hash_kernel(const u32* __restrict__ tokens,
                   const typename F::Key* __restrict__ keys,
                   u64* __restrict__ part, long long* __restrict__ out,
                   int B, int N, int cols) {
  __shared__ typename F::Key skey[SH_TILE];
  const int c0 = blockIdx.x * SH_TILE;
  const int cn = min(SH_TILE, cols - c0);
  for (int i = threadIdx.x; i < cn; i += SH_THREADS) skey[i] = keys[c0 + i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * SH_ROWS;
  for (int r = warp; r < SH_ROWS; r += SH_THREADS / 32) {
    const int b = row0 + r;
    if (b >= B) break;  // the same for the whole warp
    const u32* tok = tokens + (size_t)b * N + c0;
    u64 acc = 0;
    if (!PAIRWISE) {
#pragma unroll 4
      for (int i = lane; i < cn; i += 32) acc = F::add(acc, F::term(skey[i], tok[i]));
    } else {
      // cn is even, so both lanes of a pair lie in the tile.
#pragma unroll 4
      for (int i = 2 * lane; i < cn; i += 64)
        acc = F::add(acc, F::pair(skey[i], skey[i + 1], tok[i], tok[i + 1]));
    }
    acc = warp_combine<F>(acc);
    if (lane == 0) {
      if (gridDim.x == 1)
        write_acc(out, b, acc);
      else
        part[(size_t)b * gridDim.x + blockIdx.x] = acc;
    }
  }
}

// Second pass for S > 1 tiles: one warp combines row b's S partials.
template <class F>
__global__ void __launch_bounds__(SH_THREADS)
single_hash_finish(const u64* __restrict__ part, long long* __restrict__ out,
                   int B, int S) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (SH_THREADS / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // the same for the whole warp
  u64 acc = 0;
  for (int j = lane; j < S; j += 32) acc = F::add(acc, part[(size_t)b * S + j]);
  acc = warp_combine<F>(acc);
  if (lane == 0) write_acc(out, b, acc);
}

// Tiles of a row of `cols` columns (at least one, so an empty row writes 0).
__host__ __device__ inline int single_hash_tiles(int cols) {
  return cols <= SH_TILE ? 1 : (cols + SH_TILE - 1) / SH_TILE;
}

// Launch both passes on `stream`; part holds B * S u64 when S > 1 (the
// wrapper allocates it). Returns cudaGetLastError() after the launches.
template <class F>
int launch_single_hash(const void* tokens, const void* keys, void* part,
                       void* out, int B, int N, int pairwise, void* stream) {
  const int cols = pairwise ? N & ~1 : N;
  const int S = single_hash_tiles(cols);
  const dim3 grid(S, (B + SH_ROWS - 1) / SH_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  const u32* t = (const u32*)tokens;
  const typename F::Key* k = (const typename F::Key*)keys;
  u64* p = (u64*)part;
  long long* o = (long long*)out;
  if (pairwise)
    single_hash_kernel<F, true><<<grid, SH_THREADS, 0, s>>>(t, k, p, o, B, N, cols);
  else
    single_hash_kernel<F, false><<<grid, SH_THREADS, 0, s>>>(t, k, p, o, B, N, cols);
  if (S > 1) {
    const int rows_per_block = SH_THREADS / 32;
    single_hash_finish<F><<<(B + rows_per_block - 1) / rows_per_block,
                            SH_THREADS, 0, s>>>(p, o, B, S);
  }
  return (int)cudaGetLastError();
}
