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
// What bounds it: operations. Hopper has no carry-less multiply; done
// bit-serially a 32x32 -> 63-bit product is 32 shift-mask-xor steps on a
// u64, far more than the 4 bytes of a token cost. Design (engine_tile.cuh):
// a lane owns a row and its K sums, tokens are staged in shared memory with
// the length code applied, and no lanes are reduced across (xor is exact in
// any order). Where the caller gives per-row lengths the rows run in length
// order, longest first, so a warp's products stop near its rows' own ends
// (in a shuffled batch of documents a warp of consecutive rows ran to its
// longest, 3.16 x the live columns); the longest rows' blocks then start
// first and their columns are split (autotune.ENGINE_GF_ORDERED_UNITS), so
// no SM is left with them at the end. The key at column c is the same for
// every row, so the block turns it into a 4-bit window table once per
// tile, shared by its 256 rows:
// T[v] = clmul(key, v) for v < 16 (16 u64 of at most 35 bits, 128 bytes, so
// 32 lanes reading any nibbles of one table hit 32 banks without conflict).
// A product is then eight lookups in Horner form, r = T[n7], r = (r << 4) ^
// T[n_j] for j = 6..0 (at most 63 bits), about 4 integer operations and one
// 8-byte shared-memory read each; a token's eight nibble offsets are shared
// by its K products. The tables of 16 columns (ET_TABLE_COLS) are built
// at a time, which keeps a 256-row block's shared memory small enough for
// two blocks an SM. What holds it is the design's own floor: its integer
// operations and its 64 bytes of table reads a product (the shared-memory
// rate), far above the bytes. The HM pair term has no fixed operand (both
// factors carry a token), so it keeps the bit-serial clmul32 on broadcast
// keys.
#include "engine_tile.cuh"

// Set by kernels/autotune.py::ENGINE, which also sizes the column split.
#if !defined(ET_GF_THREADS) || !defined(ET_GF_MIN_BLOCKS)
#error "ET_GF_*: build with repro_torch/kernels/_build.py"
#endif

#define GF_POLY_LOW 0xC5u

// Product with the 33-bit p = 2^32 + POLY_LOW; a < 2^31 here.
__device__ __forceinline__ u64 clmul_poly(u64 a) {
  return clmul32((u32)a, GF_POLY_LOW) ^ (a << 32);
}

// 63-bit carry-less accumulator mod p(x) (paper Appendix B, Knezevic et al.).
__device__ __forceinline__ u32 barrett(u64 acc) {
  const u64 q3 = clmul_poly(acc >> 32) >> 32;
  return (u32)((acc ^ clmul_poly(q3)) & 0xffffffffull);
}

struct GfEngine {
  static constexpr int THREADS = ET_GF_THREADS;  // rows per block
  static constexpr int MIN_BLOCKS = ET_GF_MIN_BLOCKS;  // as in multihash.cu

  static __device__ __forceinline__ u64 add(u64 a, u64 b) { return a ^ b; }

  // Plain: the window tables of a chunk, tab[kk][j][v] = clmul(key of
  // function kk at column j, v) for v < 16, for the ET_TABLE_COLS columns
  // from kc (kc[j * KCP + kk] is a staged key). HM: no table; the pair term
  // reads the staged keys.
  static constexpr bool HAS_MMA = false;

  template <int KC, bool PAIRWISE, bool MMA>
  static __host__ __device__ constexpr size_t table_bytes() {
    return PAIRWISE ? 0 : (size_t)KC * ET_TABLE_COLS * 16 * 8;
  }

  template <int KC>
  static __device__ __forceinline__ void build(u64* tab, const u64* kc, int tid) {
    for (int i = tid; i < KC * ET_TABLE_COLS * 16; i += THREADS) {
      const int v = i & 15, j = (i >> 4) % ET_TABLE_COLS, kk = (i >> 4) / ET_TABLE_COLS;
      const u64 k = kc[j * et_kcp<KC>() + kk] & 0xffffffffull;
      tab[i] = ((v & 1) ? k : 0ull) ^ ((v & 2) ? k << 1 : 0ull) ^
               ((v & 4) ? k << 2 : 0ull) ^ ((v & 8) ? k << 3 : 0ull);
    }
  }

  template <int KC>
  static __device__ __forceinline__ void column(u64 (&acc)[KC], const u64* tab,
                                                int j, u32 t) {
    const u64* tj = tab + j * 16;
    int nib[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) nib[n] = (t >> (4 * n)) & 15u;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const u64* T = tj + kk * (ET_TABLE_COLS * 16);
      u64 r = T[nib[7]];
#pragma unroll
      for (int n = 6; n >= 0; --n) r = (r << 4) ^ T[nib[n]];
      acc[kk] ^= r;
    }
  }

  template <int KC>
  static __device__ __forceinline__ void pair(u64 (&acc)[KC], const u64* kd,
                                              int j, u32 s0, u32 s1, bool live) {
    const u64* ka = kd + j * et_kcp<KC>();
    const u64* kb = ka + et_kcp<KC>();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const u64 p = clmul32((u32)ka[kk] ^ s0, (u32)kb[kk] ^ s1);
      acc[kk] ^= live ? p : 0ull;
    }
  }

  static __device__ __forceinline__ void finish(u64 total, u64 m1, u64 mod_m,
                                                u64 mu, long long* o) {
    const u64 a = total ^ (m1 & 0xffffffffull);  // m1 lo
    const u32 h32 = barrett(a);
    const u32 acc_hi = (u32)(a >> 32);
    if (mod_m) {
      o[0] = (long long)mod_by(((u64)h32 << 32) | acc_hi, mod_m, mu);
      o[1] = (long long)h32;
    } else {
      o[0] = (long long)h32;
      o[1] = (long long)acc_hi;
    }
  }
};

extern "C" int repro_gf_multihash(const void* tokens, const void* keys,
                                  const void* lens, void* out, void* part,
                                  int B, int N, int W, int K, long long ldk,
                                  int pairwise, int split,
                                  unsigned long long mod_m, void* order,
                                  void* stats, void* stream) {
  return launch_engine<GfEngine>(tokens, keys, lens, out, part, B, N, W, K,
                                 ldk, pairwise, split, mod_m, order, stats, stream);
}

extern "C" long long repro_gf_multihash_smem(int K, int pairwise) {
  return (long long)engine_smem_bytes<GfEngine>(K, pairwise);
}
