// Skeleton of the carry-less single-hash kernel (gf_multilinear.cu): one
// keyed GF(2^32) Multilinear(-HM) hash of each of B fixed-length rows of N
// u32 tokens, as the raw 63-bit accumulator (hi, lo) or, with `finish`,
// the finished hash Barrett(acc ^ m1) mod p(x) as one int64 a row.
//
// Grid: (S column splits, row blocks of GS_BLOCK_ROWS). The shapes run from
// many short rows (B 65,536 x N 1,024) to a few long ones (B 64 x N 2^20);
// when the row blocks alone do not fill the card the wrapper splits the
// columns (kernels/autotune.py::gf_single_split) and a second pass combines
// each row's S partials by xor, exact in any order. Whichever pass writes a
// row runs the finish. A column past the split's end (or a row past B)
// reads as a zero token and a zero key, which adds nothing: this pads the
// tail of a split and N of 1, 2 or 7.
//
// Plain family, on the b1 tensor cores. acc[b] = xor_i clmul(k_i, s[b][i])
// is a GF(2) matrix product: bit j of acc[b] is the parity of
//   sum_i sum_v s[b][i][v] & k_i[j - v],
// so A = each row's tokens as bits (a token is its own 32 bits of A), B =
// for each key a 32 x 64 Toeplitz matrix of its bits, and
// mma.sync.m16n8k256.b1.and.popc counts the AND of 256 bits (8 tokens) of
// 16 rows with 8 output bits. The parity of a count is the GF(2) sum, so
// only bit 0 is kept, at the end; the s32 counts (at most 32 a token) are
// exact below 2^26 columns a split (GS_MAX_SPLIT). A warp owns 16 rows (one
// m16 tile), 8 n-tiles give the 64 output bits (32 s32 sums a lane), and a
// lane builds its B words from the keys in registers: bit v of the word of
// key k for output bit j is k[j - v], a funnel shift of brev(k), 8 a key for
// the lane's output bits 8 nt + g, shared by the warp's 16 rows. Tokens and
// keys reach a per-warp ring in shared memory by cp.async, steps ahead.
// What holds it is the memory: the mma work takes about half the bytes'
// time at the b1 rate measured on an H100.
//
// HM family, on the integer units. Both factors of
// clmul(k_2p ^ s_2p, k_2p+1 ^ s_2p+1) carry a token, so no table of the
// keys helps. A warp walks one row at a time, lanes striding over pairs
// with 16-byte loads straight into registers (each load of a warp covers
// whole 32-byte sectors), and each pair is an integer-multiply carry-less
// product with holes (bmul_acc): 16 32x32 -> 64-bit multiplies instead of
// 32 shift-mask-xor steps on a u64. What holds it is those operations.
#pragma once

#include "engine_common.cuh"

// Set by kernels/autotune.py::GF_SINGLE.
#if !defined(GS_THREADS) || !defined(GS_MIN_BLOCKS) || !defined(GS_HM_MIN_BLOCKS)
#error "GS_*: build with repro_torch/kernels/_build.py"
#endif

#define GS_WARP_ROWS 16                              // rows a warp owns
#define GS_BLOCK_ROWS (GS_THREADS / 32 * GS_WARP_ROWS)  // rows a block owns
#define GS_STEP 32            // columns a warp hashes in one loop step
#define GS_STAGES 4           // ring slots of a warp: steps in flight + 1
// A ring slot: 16 rows x GS_STEP tokens (gs_swizzle), then GS_STEP keys.
#define GS_SLOT (GS_WARP_ROWS * GS_STEP + GS_STEP)
#define GS_MAX_SPLIT (1 << 26)  // most columns a split: the s32 counts
#define GS_FULL 0xffffffffu
#define GF_POLY_LOW 0xC5u

static_assert(GS_THREADS % 32 == 0, "whole warps only");

// Product with the 33-bit p = 2^32 + POLY_LOW; a < 2^31 here.
__device__ __forceinline__ u64 clmul_poly(u64 a) {
  return clmul32((u32)a, GF_POLY_LOW) ^ (a << 32);
}

// 63-bit carry-less accumulator mod p(x) (paper Appendix B, Knezevic et al.).
__device__ __forceinline__ u32 barrett(u64 acc) {
  const u64 q3 = clmul_poly(acc >> 32) >> 32;
  return (u32)((acc ^ clmul_poly(q3)) & 0xffffffffull);
}

// z[r] ^= the class-r terms of clmul(a, b) (Pornin's bmul, BearSSL
// ghash_ctmul). a_c = a & (0x11111111 << c), likewise b; in the integer
// product a_c * b_d every bit position meets at most 8 terms, fewer than
// the 16 that would carry into the next position of its class c + d mod 4,
// so the bits of class r of xor_(c + d = r mod 4) a_c * b_d are those of
// the carry-less product. Masking is linear over xor, so the class masks
// wait for bmul_fold, once a row.
__device__ __forceinline__ void bmul_acc(u64 (&z)[4], u32 a, u32 b) {
  const u32 m = 0x11111111u;
  const u64 a0 = a & m, a1 = a & (m << 1), a2 = a & (m << 2), a3 = a & (m << 3);
  const u64 b0 = b & m, b1 = b & (m << 1), b2 = b & (m << 2), b3 = b & (m << 3);
  z[0] ^= (a0 * b0) ^ (a1 * b3) ^ (a2 * b2) ^ (a3 * b1);
  z[1] ^= (a0 * b1) ^ (a1 * b0) ^ (a2 * b3) ^ (a3 * b2);
  z[2] ^= (a0 * b2) ^ (a1 * b1) ^ (a2 * b0) ^ (a3 * b3);
  z[3] ^= (a0 * b3) ^ (a1 * b2) ^ (a2 * b1) ^ (a3 * b0);
}

__device__ __forceinline__ u64 bmul_fold(const u64 (&z)[4]) {
  const u64 m = 0x1111111111111111ull;
  return (z[0] & m) ^ (z[1] & (m << 1)) ^ (z[2] & (m << 2)) ^ (z[3] & (m << 3));
}

// d += popc(a AND b) on the b1 tensor cores: a 16 x 256-bit tile (row-major
// fragment: a0 rows g, a1 rows g + 8, bits 32 t..; a2, a3 the same rows,
// bits 128 + 32 t..), b 256 bits x 8 columns (column-major: b0 column g
// bits 32 t.., b1 bits 128 + 32 t..), d 16 x 8 s32 (d0, d1 row g columns
// 2 t, 2 t + 1; d2, d3 row g + 8).
__device__ __forceinline__ void mma_b1(int (&d)[4], const u32 (&a)[4], u32 b0,
                                       u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B word of key k (r = brev(k), whose bit 31 - u is k[u]) for output
// bit j = 8 NT + g: bit v is k[j - v], i.e. r >> (31 - j) for j < 32 and
// r << (j - 31) (mod 2^32) above. kernels/ref.py::toeplitz_word is its twin.
template <int NT>
__device__ __forceinline__ u32 toeplitz_word(u32 r, int g) {
  return NT < 4 ? __funnelshift_lc(r, 0u, 8 * NT + g + 1)
                : __funnelshift_lc(0u, r, 8 * NT + g - 31);
}

__device__ __forceinline__ unsigned gs_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void gs_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void gs_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage columns c .. c + 3 of a row into dst by cp.async, zero-filling those
// at and past `end`: 16 bytes when `vec` (the row is 16-byte aligned), else
// 4 at a time. A copy of 0 source bytes reads nothing (its source is the
// row's start) and writes zeros.
__device__ __forceinline__ void gs_stage4(u32* dst, const u32* __restrict__ row,
                                          int c, int end, bool vec) {
  if (vec) {
    const int n = min(max(end - c, 0), 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(gs_smem_addr(dst)),
                 "l"(n ? row + c : row), "r"(4 * n)
                 : "memory");
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = c + e < end;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(gs_smem_addr(dst + e)),
                   "l"(live ? row + c + e : row), "r"(live ? 4 : 0)
                   : "memory");
    }
  }
}

// Word offset of row r's 16-byte group q (columns 4 q ..) in a ring slot:
// odd rows swap the two halves of their 8 groups, so the 8 lanes of a
// quarter-warp reading group t of rows g and g + 1 meet 32 distinct banks.
__host__ __device__ constexpr int gs_swizzle(int r, int q) {
  return r * GS_STEP + 4 * (q ^ ((r & 1) << 2));
}

// Columns c .. c + 3 of a row (zero at and past `ce`): one 16-byte load// Columns c .. c + 3 of a row (zero at and past `ce`): one 16-byte load
// when `vec` (the row is 16-byte aligned) and all four lie before ce.
__device__ __forceinline__ uint4 gs_load4(const u32* __restrict__ p, int c,
                                          int ce, bool vec) {
  if (vec && c + 4 <= ce) return __ldg((const uint4*)(p + c));
  uint4 v;
  v.x = c < ce ? __ldg(p + c) : 0u;
  v.y = c + 1 < ce ? __ldg(p + c + 1) : 0u;
  v.z = c + 2 < ce ? __ldg(p + c + 2) : 0u;
  v.w = c + 3 < ce ? __ldg(p + c + 3) : 0u;
  return v;
}

// Row b's result: the raw (acc >> 32, acc & 0xFFFFFFFF) into out (B, 2),
// or with `finish` Barrett(acc ^ m1) into out (B,); keys[0] is m1 then.
__device__ __forceinline__ void gs_write(long long* __restrict__ out,
                                         const u32* __restrict__ keys, int b,
                                         u64 acc, int finish) {
  if (finish) {
    out[b] = (long long)barrett(acc ^ keys[0]);
  } else {
    out[(size_t)b * 2] = (long long)(acc >> 32);
    out[(size_t)b * 2 + 1] = (long long)(acc & 0xffffffffull);
  }
}

// Row b's partial of this split: written as the result when there is one
// split, else to part[b * S + split] for gf_single_finish.
__device__ __forceinline__ void gs_emit(long long* __restrict__ out,
                                        u64* __restrict__ part,
                                        const u32* __restrict__ keys, int b,
                                        u64 acc, int finish) {
  if (gridDim.x == 1)
    gs_write(out, keys, b, acc, finish);
  else
    part[(size_t)b * gridDim.x + blockIdx.x] = acc;
}

// The plain family. pk: the positional keys (keys + finish); cols = N.
// Each warp stages its own 16 rows and the step's keys into a ring of
// GS_STAGES slots by cp.async, GS_STAGES - 1 steps ahead, so no block
// barrier is needed and many bytes are in flight for few registers.
// Lane (g, t) of a warp reads, per 16 columns, tokens 4 t .. 4 t + 3 of
// its rows g and g + 8 and the same 4 keys; its first k-step takes tokens
// 4 t and 4 t + 1 as its bits 32 t.. and 128 + 32 t.. of A, the second
// 4 t + 2 and 4 t + 3, and its B words come from the same keys, so A and
// B agree on which token each 32 bits of the 256 are (any such order sums
// the same).
__global__ void __launch_bounds__(GS_THREADS, GS_MIN_BLOCKS)
gf_single_mma(const u32* __restrict__ tokens, const u32* __restrict__ keys,
              const u32* __restrict__ pk, u64* __restrict__ part,
              long long* __restrict__ out, int B, int N, int split, int vec,
              int kvec, int finish) {
  __shared__ __align__(16) u32 smem[GS_THREADS / 32 * GS_STAGES * GS_SLOT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * GS_BLOCK_ROWS + warp * GS_WARP_ROWS;
  if (r0 >= B) return;  // the same for the whole warp
  const int cs = blockIdx.x * split, ce = min(N, cs + split);
  u32* ring = smem + warp * GS_STAGES * GS_SLOT;

  // This lane stages group q = lane % 8 (columns 4 q ..) of rows
  // lane / 8 + 4 i, and lanes 0-7 the keys' group q. A row past B reads as
  // zeros (its end is cs) and is never written.
  const int q = lane & 7;
  const u32* src[4];
  int end[4], dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = (lane >> 3) + 4 * i;
    src[i] = tokens + (size_t)min(r0 + rr, B - 1) * N;
    end[i] = r0 + rr < B ? ce : cs;
    dst[i] = gs_swizzle(rr, q);
  }
  auto stage = [&](int c0, u32* slot) {
#pragma unroll
    for (int i = 0; i < 4; ++i) gs_stage4(slot + dst[i], src[i], c0 + 4 * q, end[i], vec);
    if (lane < 8) gs_stage4(slot + GS_WARP_ROWS * GS_STEP + 4 * q, pk, c0 + 4 * q, ce, kvec);
  };

  int d[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0;
  // One k-step: tokens (s0 of rows g / g + 8, then s1) against keys k0, k1.
  auto kstep = [&](u32 sa0, u32 sb0, u32 sa1, u32 sb1, u32 k0, u32 k1) {
    const u32 a[4] = {sa0, sb0, sa1, sb1};
    const u32 q0 = __brev(k0), q1 = __brev(k1);
    mma_b1(d[0], a, toeplitz_word<0>(q0, g), toeplitz_word<0>(q1, g));
    mma_b1(d[1], a, toeplitz_word<1>(q0, g), toeplitz_word<1>(q1, g));
    mma_b1(d[2], a, toeplitz_word<2>(q0, g), toeplitz_word<2>(q1, g));
    mma_b1(d[3], a, toeplitz_word<3>(q0, g), toeplitz_word<3>(q1, g));
    mma_b1(d[4], a, toeplitz_word<4>(q0, g), toeplitz_word<4>(q1, g));
    mma_b1(d[5], a, toeplitz_word<5>(q0, g), toeplitz_word<5>(q1, g));
    mma_b1(d[6], a, toeplitz_word<6>(q0, g), toeplitz_word<6>(q1, g));
    mma_b1(d[7], a, toeplitz_word<7>(q0, g), toeplitz_word<7>(q1, g));
  };

  const int steps = ce > cs ? (ce - cs + GS_STEP - 1) / GS_STEP : 0;
#pragma unroll
  for (int i = 0; i < GS_STAGES - 1; ++i) {
    if (i < steps) stage(cs + i * GS_STEP, ring + i * GS_SLOT);
    gs_commit();
  }
  for (int i = 0; i < steps; ++i) {
    gs_wait<GS_STAGES - 2>();  // this lane's copies of step i landed
    __syncwarp();  // everyone's have; the slot of step i - 1 is read
    const int nx = i + GS_STAGES - 1;
    if (nx < steps) stage(cs + nx * GS_STEP, ring + (nx % GS_STAGES) * GS_SLOT);
    gs_commit();
    const u32* slot = ring + (i % GS_STAGES) * GS_SLOT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 xa = *(const uint4*)(slot + gs_swizzle(g, 4 * h + t));
      const uint4 xb = *(const uint4*)(slot + gs_swizzle(g + 8, 4 * h + t));
      const uint4 xk = *(const uint4*)(slot + GS_WARP_ROWS * GS_STEP + 4 * (4 * h + t));
      kstep(xa.x, xb.x, xa.y, xb.y, xk.x, xk.y);
      kstep(xa.z, xb.z, xa.w, xb.w, xk.z, xk.w);
    }
  }
  gs_wait<0>();

  // Lane (g, t) holds bits 8 nt + 2 t and + 1 of rows g (d0, d1) and g + 8
  // (d2, d3); the four lanes of a quad or theirs together.
  const int ra = r0 + g, rb = r0 + g + 8;
  u64 acc_a = 0, acc_b = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = 8 * nt + 2 * t;
    acc_a |= ((u64)(d[nt][0] & 1) << j) | ((u64)(d[nt][1] & 1) << (j + 1));
    acc_b |= ((u64)(d[nt][2] & 1) << j) | ((u64)(d[nt][3] & 1) << (j + 1));
  }
  acc_a |= __shfl_xor_sync(GS_FULL, acc_a, 1);
  acc_b |= __shfl_xor_sync(GS_FULL, acc_b, 1);
  acc_a |= __shfl_xor_sync(GS_FULL, acc_a, 2);
  acc_b |= __shfl_xor_sync(GS_FULL, acc_b, 2);
  if (t == 0 && ra < B) gs_emit(out, part, keys, ra, acc_a, finish);
  if (t == 1 && rb < B) gs_emit(out, part, keys, rb, acc_b, finish);
}

// The HM family. cols = 2 floor(N / 2): the reference pads an odd row with
// a zero token and a zero key, so its last token pairs with zeros and adds
// nothing. A warp walks its 16 rows one at a time; lane l takes columns
// 4 l .. 4 l + 3 of every 128 (two pairs), and a shuffle xors the lanes.
__global__ void __launch_bounds__(GS_THREADS, GS_HM_MIN_BLOCKS)
gf_single_hm(const u32* __restrict__ tokens, const u32* __restrict__ keys,
             const u32* __restrict__ pk, u64* __restrict__ part,
             long long* __restrict__ out, int B, int N, int split, int vec,
             int kvec, int finish) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = N & ~1;
  const int cs = blockIdx.x * split, ce = min(cols, cs + split);
  const int r0 = blockIdx.y * GS_BLOCK_ROWS + warp * GS_WARP_ROWS;
  for (int b = r0; b < min(B, r0 + GS_WARP_ROWS); ++b) {
    const u32* tok = tokens + (size_t)b * N;
    u64 z[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int c = cs + 4 * lane; c < ce; c += 128) {
      const uint4 s = gs_load4(tok, c, ce, vec);
      const uint4 k = gs_load4(pk, c, ce, kvec);
      bmul_acc(z, k.x ^ s.x, k.y ^ s.y);
      bmul_acc(z, k.z ^ s.z, k.w ^ s.w);
    }
    u64 acc = bmul_fold(z);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc ^= __shfl_xor_sync(GS_FULL, acc, off);
    if (lane == 0) gs_emit(out, part, keys, b, acc, finish);
  }
}

// Second pass for S > 1 splits: one warp xors row b's S partials and
// writes the row.
__global__ void __launch_bounds__(256)
gf_single_finish(const u64* __restrict__ part, const u32* __restrict__ keys,
                 long long* __restrict__ out, int B, int S, int finish) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (b >= B) return;  // the same for the whole warp
  u64 acc = 0;
  for (int j = lane; j < S; j += 32) acc ^= part[(size_t)b * S + j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc ^= __shfl_xor_sync(GS_FULL, acc, off);
  if (lane == 0) gs_write(out, keys, b, acc, finish);
}

// Launch both passes on `stream`. keys: N keys, or with `finish` N + 1 with
// m1 first. part holds B * S u64 when S = ceil(cols / split) > 1 (the
// wrapper allocates it). Returns the first CUDA error.
inline int launch_gf_single(const void* tokens, const void* keys, void* part,
                            void* out, int B, int N, int pairwise, int finish,
                            int split, void* stream) {
  if (split <= 0 || split % GS_STEP || split > GS_MAX_SPLIT || B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  const int cols = pairwise ? N & ~1 : N;
  const int S = cols > split ? (cols + split - 1) / split : 1;
  const dim3 grid(S, (B + GS_BLOCK_ROWS - 1) / GS_BLOCK_ROWS);
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const u32* t = (const u32*)tokens;
  const u32* k = (const u32*)keys;
  const u32* pk = k + (finish ? 1 : 0);
  const int vec = (uintptr_t)t % 16 == 0 && N % 4 == 0;
  const int kvec = (uintptr_t)pk % 16 == 0;
  u64* p = (u64*)part;
  long long* o = (long long*)out;
  if (pairwise)
    gf_single_hm<<<grid, GS_THREADS, 0, s>>>(t, k, pk, p, o, B, N, split, vec, kvec, finish);
  else
    gf_single_mma<<<grid, GS_THREADS, 0, s>>>(t, k, pk, p, o, B, N, split, vec, kvec, finish);
  if (S > 1)
    gf_single_finish<<<(B + 7) / 8, 256, 0, s>>>(p, k, o, B, S, finish);
  return (int)cudaGetLastError();
}

// Rate probe of the b1 mma: each warp runs `iters` x 8 independent
// m16n8k256 and/popc products (the plain family's inner loop without its
// loads), so blocks x warps x iters x 8 / time is the card's rate.
__global__ void __launch_bounds__(GS_THREADS)
gf_b1_rate(int iters, int* __restrict__ sink) {
  const u32 x = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const u32 a[4] = {x, ~x, x * 3u, x ^ 0x5555AAAAu};
  int d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_b1(d[nt], a, x + nt, ~x - i);
  }
  int v = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) v += d[nt][0] + d[nt][1] + d[nt][2] + d[nt][3];
  sink[blockIdx.x * GS_THREADS + threadIdx.x] = v;
}
