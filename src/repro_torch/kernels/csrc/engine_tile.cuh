// Shared skeleton of the fused K-hash engine kernels (multihash.cu,
// gf_multihash.cu): K keyed hashes of each of B rows of u32 tokens under
// the length codes, with m1 and the slot epilogue fused in. A family F
// supplies the per-column term (and the HM pair term), optionally a table
// built from each tile's keys, optionally a tensor-core path over a warp's
// rows, the combining operation (+ mod 2^64 or xor: both exact in any
// order) and the epilogue that writes a row's two slots.
//
// Layout. A block owns F::THREADS rows, one per lane, and a range of
// columns (the split; all W columns unless the rows alone cannot fill the
// card). Each lane keeps its row's sums in registers, so no lanes are
// reduced across. The columns go in tiles of ET_TILE, loaded ET_STAGES - 1
// tiles ahead by cp.async into a ring of shared-memory buffers, so the next
// tiles load while this one is hashed:
// - tokens: each warp stages its own 32 rows in 16-byte chunks, 8 lanes to
//   a row segment (coalesced). The length code is applied while staging: a
//   column at or past the row's live tokens is stored as 0, or 1 at the
//   sentinel, and never loaded, so the inner loop reads ready tokens, 4
//   columns at a time;
// - keys: the block stages the tile's K key columns, once for its rows;
//   every lane reads the same column at the same time, so a read is a
//   broadcast. A family with a table (the carry-less window table, the
//   integer tensor-core B operand) builds it from them once per tile;
// - a launch pass hashes a register chunk of KC <= 9 functions; more
//   functions take more passes over the columns.
// A warp stops at the largest kend among its rows, a block at the largest
// among its warps. With one split the lane runs the epilogue itself;
// otherwise it writes its partial sums to part[split][k][b] and
// engine_finish combines the splits and runs the epilogue.
//
// Row order. Given an `order`, the launch's rows go to lanes through it:
// order[p] is the row at place p, and the places of each segment of
// EO_SEG rows hold its rows sorted by kend, longest first
// (engine_order_kernel, launched before the tile kernel). A warp then holds
// 32 rows of nearly one kend, so it hashes little past its rows' ends (in
// a shuffled batch of documents a warp of consecutive rows ran to its
// longest row, 3.16 x the live columns), and the blocks that start first
// hold the longest rows (of a segment; a call of up to EO_SEG rows is one
// segment). The tokens are read
// from, and the slots and partials written at, the row itself; only the
// lane a row runs on changes, and + mod 2^64 and xor are exact in any
// order. Without an order (null) place p holds row p.
//
// Counts. Given a non-null `stats` (the port's tracer is on), each warp
// adds the lane columns it hashes in its split, 32 x (wend - cs), and the
// live ones, the sum over its lanes of the row's tokens and sentinel inside
// the split (exact below 2^27 columns a row), to one of ET_STAT_SLOTS
// pairs, each on its own 256-byte line: one atomicAdd each a warp, and
// warps that start together add to different lines (a single pair for
// every warp cost the kernel 1.5 % of its time at 2^20 rows of 13 tokens
// on an H100). The sums over the pairs give the lane waste. A null
// `stats` costs one test.
#pragma once

#include "engine_common.cuh"

#define ET_STAGES 2               // ring slots: tiles in flight + 1
#define ET_TABLE_COLS 16          // columns one window-table build spans
#define ET_TILE 32                // columns per tile
#define ET_MAX_SPLIT 8192         // most columns of a split (tensor-core path)
// Row stride of a staged token tile, in words: 16-byte aligned for 16-byte
// copies, and 8 consecutive rows' 16-byte reads (a quarter-warp) fall in 8
// distinct bank groups, so a warp reading 4 columns of its 32 rows has no
// bank conflict.
#define ET_STRIDE (ET_TILE + 4)
#define ET_FULL 0xffffffffu
#define ET_STAT_SLOTS 64          // pairs of counts (tracing.ENGINE_SLOTS)
#define ET_STAT_STRIDE 32         // u64 from one pair to the next
// Row order: threads of an ordering block, the rows it orders (a segment:
// a row's place in it fits 16 bits) and the codes a thread reads at a time.
#define EO_THREADS 1024
#define EO_SEG 65536
#define EO_UNROLL 32
// Set by kernels/autotune.py::ENGINE_ORDER_MAX_WIDTH: the widest row
// ordered (W / 2 + 1 buckets, counted in shared memory).
#if !defined(EO_MAX_WIDTH)
#error "EO_MAX_WIDTH: build with repro_torch/kernels/_build.py"
#endif

// Key row length for KC functions, rounded up to an even count so a
// column's keys start 16-byte aligned.
template <int KC>
__host__ __device__ constexpr int et_kcp() { return (KC + 1) & ~1; }

// A row under its length code (repro/kernels/multihash.py::_mask_tile):
// code >= 0 is a variable-length row of lm = code tokens and the sentinel
// 1 at lm; code < 0 a fixed-length row of lm = -code-1. It loads ld tokens,
// ends at `end` (its tokens and sentinel) and hashes key lanes below kend =
// even(end), at most W.
struct EtRow {
  int ld, sent, end, kend;
};
__device__ __forceinline__ EtRow et_row(int code, int N, int W) {
  const bool is_var = code >= 0;
  const int lm = is_var ? code : -code - 1;
  EtRow r;
  r.end = lm + (is_var ? 1 : 0);
  r.ld = min(lm, N);
  r.sent = (is_var && lm < W) ? lm : -1;
  r.kend = min(r.end + (r.end & 1), W);
  return r;
}

// The row order's buckets: one for each kend a row of width W can have (the
// even ones and W), bucket (kend + 1) / 2.
__host__ __device__ constexpr int eo_buckets(int W) { return (W + 1) / 2 + 1; }
__device__ __forceinline__ int eo_bucket(int code, int W) {
  return (et_row(code, 0, W).kend + 1) >> 1;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(u32* dst, const u32* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(u32* dst, const u32* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x mod m for m >= 1, with mu = floor((2^64 - 1) / m) from the host: the
// quotient estimate hi64(x * mu) is never above floor(x / m) and at most 2
// below it. No u64 division on the card (its call would hold the sums
// across a function call).
__device__ __forceinline__ u64 mod_by(u64 x, u64 m, u64 mu) {
  u64 r = x - __umul64hi(x, mu) * m;
  while (r >= m) r -= m;
  return r;
}

// d += a x b on the tensor cores: a 16 x 32 u8 tile (row-major fragment
// a0..a3), b a 32 x 8 u8 tile (column-major fragment b0, b1), d 16 x 8 s32.
__device__ __forceinline__ void mma_u8(int (&d)[4], const u32 (&a)[4], u32 b0,
                                       u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one block, in bytes, by part: the key ring (ET_STAGES x
// 32 columns x KCP u64), F's table and the token ring of every warp.
template <int KC>
__host__ __device__ constexpr size_t et_keys_bytes() {
  return (size_t)ET_STAGES * ET_TILE * et_kcp<KC>() * 8;
}
template <int T>
__host__ __device__ constexpr size_t et_tokens_bytes() {
  return (size_t)T * ET_STAGES * ET_STRIDE * 4;
}
template <class F, int KC, bool PAIRWISE, bool MMA>
__host__ __device__ constexpr size_t engine_smem() {
  return et_keys_bytes<KC>() + F::template table_bytes<KC, PAIRWISE, MMA>() +
         et_tokens_bytes<F::THREADS>();
}

// The row order of B rows: engine_order_kernel, one plain launch of a
// block for each segment of EO_SEG rows (block g owns rows [g EO_SEG,
// g EO_SEG + EO_SEG)), each segment ordered on its own, so no block waits
// on another:
// 1. the block counts its rows in each bucket (shared atomics);
// 2. it scans the counts, longest bucket first, into each bucket's first
//    place;
// 3. it places its rows in shared memory, 16 bits a row, each row's place
//    taken by a shared atomic on its bucket (rows of one bucket take their
//    places in any order);
// 4. it writes the places out in order, order[g EO_SEG + place] = row, in
//    whole lines (a row placed straight into global memory costs a 32-byte
//    sector of its own, and one SM writes them one at a time).
// A thread reads EO_UNROLL codes, EO_THREADS apart, before it uses one (the
// block waits on memory, not on work). Nothing needs memory zeroed before
// it, and it needs no grid barrier. One SM orders a segment: 24 us at
// 65,536 rows of width 2,050 on an H100. A cooperative launch of 32 blocks
// sharing their counts across two grid barriers took 10.6 us there, but
// then the host's time a call, not the card's, set the pace of such
// batches, and the card idled more (PERF.md). F only names the
// kernel after its engine.

// Inclusive sum of x over the lanes up to this one.
__device__ __forceinline__ int eo_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(ET_FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Shared memory of an ordering block for rows of width W: the buckets'
// counts, then the segment's places.
__host__ __device__ constexpr size_t eo_smem(int W) {
  return eo_buckets(W) * sizeof(int) + EO_SEG * sizeof(unsigned short);
}

template <class F>
__global__ void __launch_bounds__(EO_THREADS)
engine_order_kernel(const int* __restrict__ lens, int* __restrict__ order, int B, int W) {
  static_assert(EO_THREADS == 32 * 32, "one warp scans the warps' sums");
  extern __shared__ int s_next[];  // [bucket]: counts, then the next place
  __shared__ int s_warp[32];
  const int NB = eo_buckets(W);
  unsigned short* s_ord = (unsigned short*)(s_next + NB);  // [place]: row - base
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * EO_SEG, n = min(EO_SEG, B - base);
  const int* l = lens + base;
  for (int v = tid; v < NB; v += EO_THREADS) s_next[v] = 0;
  __syncthreads();
  for (int i0 = tid; i0 < n; i0 += EO_UNROLL * EO_THREADS) {
    int c[EO_UNROLL];
#pragma unroll
    for (int j = 0; j < EO_UNROLL; ++j)
      c[j] = i0 + j * EO_THREADS < n ? l[i0 + j * EO_THREADS] : 0;
#pragma unroll
    for (int j = 0; j < EO_UNROLL; ++j)
      if (i0 + j * EO_THREADS < n) atomicAdd(&s_next[eo_bucket(c[j], W)], 1);
  }
  __syncthreads();
  // Buckets longest first: thread t takes the C buckets NB-1-tC, ... down;
  // the threads' sums are scanned across the block.
  const int C = (NB + EO_THREADS - 1) / EO_THREADS;
  const int q0 = min(NB, tid * C), q1 = min(NB, q0 + C);
  int run = 0;
  for (int q = q0; q < q1; ++q) run += s_next[NB - 1 - q];
  const int incl = eo_scan(run, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    s_warp[lane] = eo_scan(w, lane) - w;
  }
  __syncthreads();
  int start = s_warp[warp] + incl - run;
  for (int q = q0; q < q1; ++q) {
    const int v = NB - 1 - q, k = s_next[v];
    s_next[v] = start;
    start += k;
  }
  __syncthreads();
  for (int i0 = tid; i0 < n; i0 += EO_UNROLL * EO_THREADS) {
    int c[EO_UNROLL];
#pragma unroll
    for (int j = 0; j < EO_UNROLL; ++j)
      c[j] = i0 + j * EO_THREADS < n ? l[i0 + j * EO_THREADS] : 0;
#pragma unroll
    for (int j = 0; j < EO_UNROLL; ++j)
      if (i0 + j * EO_THREADS < n)
        s_ord[atomicAdd(&s_next[eo_bucket(c[j], W)], 1)] =
            (unsigned short)(i0 + j * EO_THREADS);
  }
  __syncthreads();
  for (int p = tid; p < n; p += EO_THREADS) order[base + p] = base + s_ord[p];
}

// One launch hashes K <= KC functions (keys, out and part already offset to
// them; Kt functions make a row of out). A block of F::THREADS threads owns
// as many places of the row order, one per lane.
template <class F, int KC, bool PAIRWISE, bool MMA>
__global__ void __launch_bounds__(F::THREADS, F::MIN_BLOCKS)
engine_tile_kernel(const u32* __restrict__ tokens, const u64* __restrict__ keys,
                   const int* __restrict__ lens, const int* __restrict__ order,
                   long long* __restrict__ out, u64* __restrict__ part, int B,
                   int N, int W, int K, int Kt, long long ldk, int split, int vec,
                   u64 mod_m, u64 mu, u64* __restrict__ stats) {
  constexpr int T = F::THREADS, WARPS = T / 32;
  constexpr int KCP = et_kcp<KC>();
  constexpr size_t TABLE = F::template table_bytes<KC, PAIRWISE, MMA>();
  // columns a table spans (the tensor-core path's table spans the tile)
  constexpr int TC = TABLE > 0 && !MMA ? ET_TABLE_COLS : ET_TILE;
  static_assert(T % 32 == 0, "whole warps only");
  static_assert(ET_TILE % TC == 0 && TC % 4 == 0, "tables tile the tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_end[WARPS];
  // each lane's (tokens to load, sentinel or -1, row, -)
  __shared__ int4 s_row[T];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  u64* skeys = (u64*)smem;  // [stage][column][KCP]
  u64* table = (u64*)(smem + et_keys_bytes<KC>());
  u32* wtok = (u32*)(smem + et_keys_bytes<KC>() + TABLE) +
              warp * (ET_STAGES * 32 * ET_STRIDE);  // [stage][row][column]

  // This lane's place p in the row order and the row b there (`et_row`).
  const int p = blockIdx.y * T + tid;
  // past the batch: a dead lane, never written
  int b = 0, ld = 0, sent = -1, kend = 0, end = 0;
  if (p < B) {
    b = order != nullptr ? order[p] : p;
    const EtRow r = et_row(lens[b], N, W);
    ld = r.ld;
    sent = r.sent;
    end = r.end;
    kend = r.kend;
  }
  const int cs = blockIdx.x * split;
  const int ce = min(W, cs + split);
  const int wend = min(ce, __reduce_max_sync(ET_FULL, kend));
  if (stats != nullptr) {
    const unsigned live =
        __reduce_add_sync(ET_FULL, (unsigned)max(0, min(end, ce) - cs));
    if (lane == 0) {
      const unsigned w = (blockIdx.x * gridDim.y + blockIdx.y) * WARPS + warp;
      unsigned long long* c =
          (unsigned long long*)stats + (w % ET_STAT_SLOTS) * ET_STAT_STRIDE;
      atomicAdd(c, 32ull * (unsigned)max(0, wend - cs));
      atomicAdd(c + 1, (unsigned long long)live);
    }
  }
  s_row[tid] = make_int4(ld, sent, b, 0);
  if (lane == 0) s_end[warp] = wend;
  __syncthreads();
  int bend = cs;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) bend = max(bend, s_end[w]);

  // Issue the loads of tile c0 into ring slot `slot`: this warp's tokens
  // (while it has live columns there) and the block's share of the keys.
  // Tokens go in 16-byte chunks, lane l taking chunk l % 8 of the warp's
  // lanes l / 8, l / 8 + 4, ... (each read from its row): a chunk wholly
  // below its row's ld is copied (16 bytes when `vec`: rows 16-byte
  // aligned), one wholly past it with no sentinel is stored as 0, and the
  // one chunk that straddles ld or holds the sentinel goes token by token.
  const int4* wcode = s_row + warp * 32;
  auto prefetch = [&](int c0, int slot) {
    if (c0 < wend) {
      u32* dst = wtok + slot * (32 * ET_STRIDE) + (lane >> 3) * ET_STRIDE + (lane & 7) * 4;
      const int c = c0 + (lane & 7) * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 rc = wcode[i * 4 + (lane >> 3)];
        u32* d = dst + i * 4 * ET_STRIDE;
        const u32* g = tokens + (size_t)rc.z * N + c;
        if (vec && c + 4 <= rc.x) {
          cp_async16(d, g);
        } else if (c >= rc.x && (unsigned)(rc.y - c) >= 4u) {
          *(uint4*)d = make_uint4(0, 0, 0, 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < rc.x)
              cp_async4(d + e, g + e);
            else
              d[e] = c + e == rc.y ? 1u : 0u;
          }
        }
      }
    }
    u64* kdst = skeys + (size_t)slot * ET_TILE * KCP;
    for (int e = tid; e < KC * ET_TILE; e += T) {
      const int j = e % ET_TILE, kk = e / ET_TILE, c = c0 + j;  // key column 0 is m1
      u64* d = kdst + j * KCP + kk;
      if (kk < K && c < W)
        cp_async8(d, keys + (size_t)kk * ldk + 1 + c);
      else
        *d = 0;
    }
  };

  u64 acc[KC];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) acc[kk] = 0;
  int d[2][MMA ? KC : 1][4] = {};  // tensor-core sums of the warp's 32 rows

#pragma unroll
  for (int s = 0; s < ET_STAGES - 1; ++s) {
    if (cs + s * ET_TILE < bend) prefetch(cs + s * ET_TILE, s);
    cp_async_commit();
  }
  int slot = 0;
  for (int c0 = cs; c0 < bend; c0 += ET_TILE) {
    cp_async_wait<ET_STAGES - 2>();  // this thread's loads of tile c0 landed
    __syncthreads();  // everyone's have; the slot of tile c0 - 1 is free
    {
      const int next = c0 + (ET_STAGES - 1) * ET_TILE;
      const int nslot = slot == 0 ? ET_STAGES - 1 : slot - 1;
      if (next < bend) prefetch(next, nslot);
      cp_async_commit();
    }
    const u32* trow = wtok + slot * (32 * ET_STRIDE) + lane * ET_STRIDE;
    const u64* kc = skeys + (size_t)slot * ET_TILE * KCP;  // [column][KCP]
    // Columns this warp hashes in the tile, rounded up to 4: past every
    // row's kend a token is 0 (its term 0) and an HM pair is dead.
    const int ncols = min(ET_TILE, (wend - c0 + 3) & ~3);
    for (int j0 = 0; j0 < ET_TILE; j0 += TC) {
      const int jn = min(j0 + TC, ncols);
      if constexpr (TABLE > 0) {
        if (j0 > 0) __syncthreads();  // the last table is read
        F::template build<KC>(table, kc + j0 * KCP, tid);
        __syncthreads();
      }
      if constexpr (MMA) {
        F::template mma_tile<KC>(d, trow - lane * ET_STRIDE, table, lane, jn);
      } else {
#pragma unroll 2
        for (int j = j0; j < jn; j += 4) {
          const uint4 t = *(const uint4*)(trow + j);
          if constexpr (PAIRWISE) {
            F::template pair<KC>(acc, kc, j, t.x, t.y, c0 + j < kend);
            F::template pair<KC>(acc, kc, j + 2, t.z, t.w, c0 + j + 2 < kend);
          } else {
            const u64* kd = TABLE > 0 ? table : kc;
            const int jj = TABLE > 0 ? j - j0 : j;
            F::template column<KC>(acc, kd, jj, t.x);
            F::template column<KC>(acc, kd, jj + 1, t.y);
            F::template column<KC>(acc, kd, jj + 2, t.z);
            F::template column<KC>(acc, kd, jj + 3, t.w);
          }
        }
      }
    }
    slot = slot == ET_STAGES - 1 ? 0 : slot + 1;
  }

  // Epilogue, one hash at a time from shared memory, so the sums are not
  // all held in registers through it: they go to this warp's token ring,
  // which no load targets any more.
  cp_async_wait<0>();
  __syncwarp();
  u64* stash = (u64*)wtok;  // stash[kk * 32 + row of the warp]
  if constexpr (MMA) {
    F::template mma_flush<KC>(d, stash, lane);
  } else {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) stash[kk * 32 + lane] = acc[kk];
  }
  __syncwarp();
  if (p >= B) return;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const u64 v = stash[k * 32 + lane];
    if (gridDim.x == 1)
      F::finish(v, keys[(size_t)k * ldk], mod_m, mu, out + ((size_t)b * Kt + k) * 2);
    else
      part[((size_t)blockIdx.x * K + k) * B + b] = v;
  }
}

// Second pass with S > 1 splits: thread i = k * B + b combines row b's S
// partial sums of hash k and runs the epilogue.
template <class F>
__global__ void __launch_bounds__(256)
engine_finish(const u64* __restrict__ part, const u64* __restrict__ keys,
              long long* __restrict__ out, int B, int K, int Kt, long long ldk,
              int S, u64 mod_m, u64 mu) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  const long long BK = (long long)B * K;
  if (i >= BK) return;
  const int k = (int)(i / B), b = (int)(i % B);
  u64 v = 0;
  for (int s = 0; s < S; ++s) v = F::add(v, part[s * BK + i]);
  F::finish(v, keys[(size_t)k * ldk], mod_m, mu, out + ((size_t)b * Kt + k) * 2);
}

// static: internal linkage, so `granted` below is this library's own even
// when another library holding the same kernels is loaded in the process.
template <class F, int KC, bool PAIRWISE, bool MMA>
static cudaError_t launch_engine_kc(const u32* t, const u64* k, const int* l,
                                    const int* ord, long long* o, u64* p, int B,
                                    int N, int W, int K, int Kt, long long ldk,
                                    int split, int vec, u64 mod_m, u64 mu,
                                    u64* stats, dim3 grid, cudaStream_t s) {
  constexpr size_t smem = engine_smem<F, KC, PAIRWISE, MMA>();
  // The opt-in above 48 KB, once per device (not per call: a launch then
  // enqueues nothing else, so it can be captured in a CUDA graph).
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && !granted[dev & 63]) {
    e = cudaFuncSetAttribute(engine_tile_kernel<F, KC, PAIRWISE, MMA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted[dev & 63] = true;
  }
  engine_tile_kernel<F, KC, PAIRWISE, MMA><<<grid, F::THREADS, smem, s>>>(
      t, k, l, ord, o, p, B, N, W, K, Kt, ldk, split, vec, mod_m, mu, stats);
  return cudaSuccess;
}

// The register chunk for kn functions: 1, 3 or 9.
template <class F, bool PAIRWISE>
static cudaError_t launch_engine_chunk(const u32* t, const u64* k, const int* l,
                                       const int* ord, long long* o, u64* p, int B,
                                       int N, int W, int kn, int Kt, long long ldk,
                                       int split, int vec, u64 mod_m, u64 mu,
                                       u64* stats, dim3 grid, cudaStream_t s) {
  constexpr bool MMA = F::HAS_MMA && !PAIRWISE;
  if (kn <= 1)
    return launch_engine_kc<F, 1, PAIRWISE, MMA>(t, k, l, ord, o, p, B, N, W, kn, Kt,
                                                 ldk, split, vec, mod_m, mu, stats,
                                                 grid, s);
  if (kn <= 3)
    return launch_engine_kc<F, 3, PAIRWISE, MMA>(t, k, l, ord, o, p, B, N, W, kn, Kt,
                                                 ldk, split, vec, mod_m, mu, stats,
                                                 grid, s);
  return launch_engine_kc<F, 9, PAIRWISE, MMA>(t, k, l, ord, o, p, B, N, W, kn, Kt,
                                               ldk, split, vec, mod_m, mu, stats,
                                               grid, s);
}

// The row order of B rows of width W (codes l) into ord[0, B): a block for
// each EO_SEG rows (engine_order_kernel).
template <class F>
static cudaError_t launch_order(const int* l, int* ord, int B, int W, cudaStream_t s) {
  // The opt-in above 48 KB, once per device (as launch_engine_kc's).
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!granted[dev & 63]) {
    e = cudaFuncSetAttribute(engine_order_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)eo_smem(EO_MAX_WIDTH));
    if (e != cudaSuccess) return e;
    granted[dev & 63] = true;
  }
  engine_order_kernel<F><<<(B + EO_SEG - 1) / EO_SEG, EO_THREADS, eo_smem(W), s>>>(
      l, ord, B, W);
  return cudaSuccess;
}

// Dynamic shared memory of one block of the launch for K functions (the
// C side's repro_<name>_smem reports it).
template <class F>
size_t engine_smem_bytes(int K, int pairwise) {
  if (pairwise)
    return K <= 1 ? engine_smem<F, 1, true, false>()
         : K <= 3 ? engine_smem<F, 3, true, false>()
                  : engine_smem<F, 9, true, false>();
  return K <= 1 ? engine_smem<F, 1, false, F::HAS_MMA>()
       : K <= 3 ? engine_smem<F, 3, false, F::HAS_MMA>()
                : engine_smem<F, 9, false, F::HAS_MMA>();
}

// Launch the engine on `stream`: the functions in passes of at most 9 (a
// register chunk), each the tile kernel and, with more than one split, the
// finish pass. part holds at least S * min(K, 9) * B u64 when S =
// ceil(W / split) > 1 (the wrapper allocates it; the passes reuse it in
// stream order). Rows go on grid.y, which holds at most 65,535 blocks, so
// a batch of more rows runs in chunks of that many row blocks, one after
// another on the stream: one call covers any B. With `order` (null, or
// scratch of min(B, 65,535 x F::THREADS) ints; W at most EO_MAX_WIDTH)
// each row chunk is first put in length order, segment by segment of
// EO_SEG rows (launch_order, one kernel), which every pass of the chunk
// runs through;
// rows, slots and partials stay where they are. The epilogue's reciprocal
// of mod_m is taken here, on the host. `stats`, null or the tracer's
// ET_STAT_SLOTS x ET_STAT_STRIDE u64 counts, goes to every tile launch, so
// each pass and row chunk counts its own columns. Returns the first CUDA
// error (cudaGetLastError() after the launches).
template <class F>
int launch_engine(const void* tokens, const void* keys, const void* lens,
                  void* out, void* part, int B, int N, int W, int K,
                  long long ldk, int pairwise, int split, u64 mod_m,
                  void* order, void* stats, void* stream) {
  if (F::HAS_MMA && !pairwise && split > ET_MAX_SPLIT)
    return (int)cudaErrorInvalidValue;  // the s32 sums could overflow
  if (order != nullptr && W > EO_MAX_WIDTH)
    return (int)cudaErrorInvalidValue;  // the buckets would not fit
  const int S = W > split ? (W + split - 1) / split : 1;
  constexpr int MAX_ROWS = 65535 * F::THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  u64* p = (u64*)part;
  u64* c = (u64*)stats;
  int* ord = (int*)order;
  const u64 mu = mod_m ? ~0ull / mod_m : 0;
  for (int r0 = 0; r0 < B; r0 += MAX_ROWS) {
    const int bc = min(MAX_ROWS, B - r0);
    const dim3 grid(S, (bc + F::THREADS - 1) / F::THREADS);
    const u32* t = (const u32*)tokens + (size_t)r0 * N;
    const int* l = (const int*)lens + r0;
    const int vec = ((uintptr_t)t % 16 == 0) && N % 4 == 0;
    if (ord != nullptr) {
      const cudaError_t e = launch_order<F>(l, ord, bc, W, s);
      if (e != cudaSuccess) return (int)e;
    }
    for (int k0 = 0; k0 < K; k0 += 9) {
      const int kn = min(9, K - k0);
      const u64* k = (const u64*)keys + (size_t)k0 * ldk;
      long long* o = (long long*)out + ((size_t)r0 * K + k0) * 2;
      const cudaError_t e =
          pairwise ? launch_engine_chunk<F, true>(t, k, l, ord, o, p, bc, N, W, kn, K,
                                                  ldk, split, vec, mod_m, mu, c, grid, s)
                   : launch_engine_chunk<F, false>(t, k, l, ord, o, p, bc, N, W, kn, K,
                                                   ldk, split, vec, mod_m, mu, c, grid, s);
      if (e != cudaSuccess) return (int)e;
      if (S > 1) {
        const long long n = (long long)bc * kn;
        engine_finish<F><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
            p, k, o, bc, kn, K, ldk, S, mod_m, mu);
      }
    }
  }
  return (int)cudaGetLastError();
}
