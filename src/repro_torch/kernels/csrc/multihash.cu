// Fused K-hash kernel for the integer Multilinear families
// (multilinear, multilinear_2x2, multilinear_hm) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/multihash.py::_multihash_kernel
// (launched by multihash_blocks). Computes, for every row b and function k:
//   acc = m1[k] + sum_i key[k][i] * tok_eff[b][i]      (mod 2^64)
//   HM:  acc = m1[k] + sum_p (key[k][2p] + s[2p]) * (key[k][2p+1] + s[2p+1])
// with the length-code mask and the append-1 sentinel, then writes slots
// (acc >> 32, acc & 0xFFFFFFFF), or with mod_m != 0 (acc % mod_m, acc >> 32),
// as int64 values into out (B, K, 2).
//
// What bounds it: each token is read from device memory once for all K
// functions (4 bytes) and costs K 64x32-bit multiply-adds; done as two
// 32-bit IMADs each, at K = 9 the integer instruction rate bounds it as
// tightly as the memory rate does, and the IMADs crowd out the loads.
// Design (engine_tile.cuh): a block owns 128 rows and its split of the
// columns; tokens reach shared memory by 16-byte cp.async with the length
// code applied while staging, and the tile's key columns are staged once
// per block (not once per 4 rows, as in the first port). For the plain
// families the products run on the tensor cores: key * t mod 2^64 is a sum
// over the 8 key bytes e and 4 token bytes j of byte products shifted by
// 8 (e + j), so the block turns its tile's keys into a u8 matrix B
// (columns x bytes by functions x shifts) and each warp multiplies its
// rows' token bytes by it with mma.sync m16n8k32 u8 into s32 sums, folded
// into the u64 sums at the end: the multiplies leave the integer pipes.
// The HM pair term (k + s)(k' + s') takes a lane-per-row IMAD path: a lane
// owns a row, its sums in registers, no lane reduction. More than 9
// functions take more passes. Everything is uint64_t: one u64 multiply-add
// per token replaces the reference's (hi, lo) limbs and 16-bit digit
// trick, which exist only because the TPU has no 64-bit lanes; the
// epilogue's % mod_m is exact (a host reciprocal and at most two
// corrections); + mod 2^64 is exact in any order.
#include "engine_tile.cuh"

// Set by kernels/autotune.py::ENGINE, which also sizes the column split.
#if !defined(ET_INT_THREADS) || !defined(ET_INT_MIN_BLOCKS)
#error "ET_INT_*: build with repro_torch/kernels/_build.py"
#endif

struct IntEngine {
  static constexpr int THREADS = ET_INT_THREADS;  // rows per block
  // Blocks an SM must hold: caps the registers (65,536 / (THREADS x this))
  // so ptxas neither spills nor lets one block hog the register file; the
  // column split fills SMs x this many blocks.
  static constexpr int MIN_BLOCKS = ET_INT_MIN_BLOCKS;

  static __device__ __forceinline__ u64 add(u64 a, u64 b) { return a + b; }

  // The tensor-core path (plain families). With
  // t_j the bytes of a token and key bytes e, key * t mod 2^64 =
  // sum_s 2^(8 s) sum_(j + e = s) t_j key_e over s < 8, so for each s the
  // sum over columns is an integer product of u8 matrices: A = the tokens'
  // bytes (row x (column, j)) as staged, B[(column, j)][(k, s)] = byte s - j
  // of key k (0 when s < j), D = A x B in s32 (no overflow within a split of
  // at most 8,192 columns: 4 x 255^2 x 8,192 < 2^31), then
  // sum_s D[row][(k, s)] << 8 s mod 2^64 once at the end.
  static constexpr bool HAS_MMA = true;

  // The per-tile table: none on the HM path; B as words on the tensor-core
  // path, bw[column][8 kk + s] = bytes (s, s-1, s-2, s-3) of key kk, the
  // fragment's 4 consecutive u8 of one column.
  template <int KC, bool PAIRWISE, bool MMA>
  static __host__ __device__ constexpr size_t table_bytes() {
    return MMA ? (size_t)ET_TILE * 8 * KC * 4 : 0;
  }

  template <int KC>
  static __device__ __forceinline__ void build(u64* table, const u64* kc, int tid) {
    uint4* bw = (uint4*)table;  // the 8 words of (column c, function kk)
    for (int e = tid; e < ET_TILE * KC; e += THREADS) {
      const u64 x = kc[(e / KC) * et_kcp<KC>() + e % KC];
      const u32 lo = (u32)x, hi = (u32)(x >> 32);
      // byte j of word s = key byte s - j; selector nibble 4 reads the
      // zero operand (s < 3), nibbles 4-7 read `hi` (s > 3)
      bw[2 * e] = make_uint4(__byte_perm(lo, 0, 0x4440), __byte_perm(lo, 0, 0x4401),
                             __byte_perm(lo, 0, 0x4012), __byte_perm(lo, 0, 0x0123));
      bw[2 * e + 1] = make_uint4(__byte_perm(lo, hi, 0x1234), __byte_perm(lo, hi, 0x2345),
                                 __byte_perm(lo, hi, 0x3456), __byte_perm(lo, hi, 0x4567));
    }
  }

  // d[m][kk] += the warp's rows 16 m .. 16 m + 15 (A from the staged tile,
  // `tile` = row 0 of the warp) x B for the first ncols columns (a multiple
  // of 4; tokens past a row's end are 0).
  template <int KC>
  static __device__ __forceinline__ void mma_tile(int (&d)[2][KC][4], const u32* tile,
                                                  const u64* table, int lane,
                                                  int ncols) {
    const u32* bw = (const u32*)table;
    const int g = lane >> 2, t = lane & 3;
    for (int ks = 0; ks * 8 < ncols; ++ks) {
      u32 a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const u32* r = tile + (m * 16 + g) * ET_STRIDE + ks * 8 + t;
        a[m][0] = r[0];
        a[m][1] = r[8 * ET_STRIDE];
        a[m][2] = r[4];
        a[m][3] = r[8 * ET_STRIDE + 4];
      }
      const u32* b = bw + (ks * 8 + t) * (8 * KC) + g;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const u32 b0 = b[kk * 8], b1 = b[4 * 8 * KC + kk * 8];
        mma_u8(d[0][kk], a[0], b0, b1);
        mma_u8(d[1][kk], a[1], b0, b1);
      }
    }
  }

  // stash[kk * 32 + row] = sum_s d << 8 s for the warp's 32 rows: lane
  // (g, t) holds s = 2t, 2t+1 of rows g and g + 8 of each 16-row tile; the
  // 4 lanes of a quad add their parts.
  template <int KC>
  static __device__ __forceinline__ void mma_flush(const int (&d)[2][KC][4], u64* stash,
                                                   int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        u64 lo = ((u64)(u32)d[m][kk][0] << (16 * t)) + ((u64)(u32)d[m][kk][1] << (16 * t + 8));
        u64 hi = ((u64)(u32)d[m][kk][2] << (16 * t)) + ((u64)(u32)d[m][kk][3] << (16 * t + 8));
        lo += __shfl_xor_sync(ET_FULL, lo, 1);
        hi += __shfl_xor_sync(ET_FULL, hi, 1);
        lo += __shfl_xor_sync(ET_FULL, lo, 2);
        hi += __shfl_xor_sync(ET_FULL, hi, 2);
        if (t == 0) {
          stash[kk * 32 + m * 16 + g] = lo;
          stash[kk * 32 + m * 16 + g + 8] = hi;
        }
      }
  }

  template <int KC>
  static __device__ __forceinline__ void pair(u64 (&acc)[KC], const u64* kd,
                                              int j, u32 s0, u32 s1, bool live) {
    const u64* ka = kd + j * et_kcp<KC>();
    const u64* kb = ka + et_kcp<KC>();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const u64 p = (ka[kk] + s0) * (kb[kk] + s1);
      acc[kk] += live ? p : 0ull;
    }
  }

  static __device__ __forceinline__ void finish(u64 total, u64 m1, u64 mod_m,
                                                u64 mu, long long* o) {
    const u64 h = total + m1;
    if (mod_m) {
      o[0] = (long long)mod_by(h, mod_m, mu);
      o[1] = (long long)(h >> 32);
    } else {
      o[0] = (long long)(h >> 32);
      o[1] = (long long)(h & 0xffffffffull);
    }
  }
};

extern "C" int repro_multihash(const void* tokens, const void* keys,
                               const void* lens, void* out, void* part, int B,
                               int N, int W, int K, long long ldk, int pairwise,
                               int split, unsigned long long mod_m,
                               void* order, void* stats, void* stream) {
  return launch_engine<IntEngine>(tokens, keys, lens, out, part, B, N, W, K,
                                  ldk, pairwise, split, mod_m, order, stats, stream);
}

extern "C" long long repro_multihash_smem(int K, int pairwise) {
  return (long long)engine_smem_bytes<IntEngine>(K, pairwise);
}
