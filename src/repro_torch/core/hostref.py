"""Host-side numpy (uint64) twins of the hash families and the engine.

The PyTorch port's own copy of `repro.core.hostref` (the slice it needs):
the single-hash Multilinear(-HM) oracles and the arbitrary-precision
ground truth, the length-code algebra, the vectorized integer and
carry-less multi-hash oracles, and the Barrett `mod m` twin. numpy uint64 arithmetic wraps mod
2^64 like the paper's C code, so these functions need no JAX and serve as
an independent oracle wherever the port runs, the CUDA machine included.
"""
from __future__ import annotations

import numpy as np

U64 = np.uint64
_32 = np.uint64(32)


def multilinear_np(tokens: np.ndarray, keys_u64: np.ndarray) -> np.ndarray:
    """(..., n) uint32 tokens, (>= n+1,) uint64 keys -> (...,) uint32."""
    with np.errstate(over="ignore"):  # mod-2^64 wraparound is the algorithm
        s = np.asarray(tokens).astype(U64)
        n = s.shape[-1]
        k = keys_u64[1 : n + 1]
        acc = keys_u64[0] + (k * s).sum(axis=-1, dtype=U64)
        return (acc >> _32).astype(np.uint32)


def multilinear_hm_np(tokens: np.ndarray, keys_u64: np.ndarray) -> np.ndarray:
    """MULTILINEAR-HM of (..., n) uint32 tokens, n even -> (...,) uint32."""
    with np.errstate(over="ignore"):
        s = np.asarray(tokens).astype(U64)
        n = s.shape[-1]
        if n % 2:
            raise ValueError("MULTILINEAR-HM needs an even length")
        k = keys_u64[1 : n + 1]
        a = k[0::2] + s[..., 0::2]
        b = k[1::2] + s[..., 1::2]
        acc = keys_u64[0] + (a * b).sum(axis=-1, dtype=U64)
        return (acc >> _32).astype(np.uint32)


def multilinear_np_u64(tokens: np.ndarray, keys_u64: np.ndarray) -> np.ndarray:
    """Full 64-bit accumulator (before >>32) -- used for fingerprints where
    we keep all 64 bits (checkpoint integrity, dedup)."""
    with np.errstate(over="ignore"):
        s = np.asarray(tokens).astype(U64)
        n = s.shape[-1]
        k = keys_u64[1 : n + 1]
        return keys_u64[0] + (k * s).sum(axis=-1, dtype=U64)


def mod_u64_np(h: np.ndarray, m: int) -> np.ndarray:
    """(...,) uint64 values mod 32-bit `m` -> (...,) uint32 residues.

    Barrett digit reduction (M = floor(2^96/m) + 1, power-of-two mask fast
    path) structured limb by limb: an oracle independent of both the
    kernels' native `%` and `limbs.mod_u64`'s 16-bit Horner steps.
    """
    h = np.asarray(h, U64)
    m = int(m)
    if not 1 <= m < 1 << 32:
        raise ValueError(f"modulus {m} outside the 32-bit domain [1, 2^32)")
    if m & (m - 1) == 0:
        return (h & U64(m - 1)).astype(np.uint32)
    mu = (1 << 96) // m + 1
    mu0, mu1, mu2 = (U64(mu & 0xFFFFFFFF), U64((mu >> 32) & 0xFFFFFFFF),
                     U64(mu >> 64))
    mask = U64(0xFFFFFFFF)
    hi, lo = h >> _32, h & mask
    with np.errstate(over="ignore"):
        # L = (M * x) mod 2^96 as three 32-bit limbs (partial products kept
        # in uint64, each < 2^64; limb 2 wraps mod 2^32 == mod 2^96 total)
        p0 = mu0 * lo
        p1 = mu0 * hi
        p2 = mu1 * lo
        l0 = p0 & mask
        s1 = (p0 >> _32) + (p1 & mask) + (p2 & mask)
        l1 = s1 & mask
        l2 = ((s1 >> _32) + (p1 >> _32) + (p2 >> _32)
              + ((mu1 * hi) & mask) + ((mu2 * lo) & mask)) & mask
        # r = floor(m * L / 2^96) = limb 3 of the (m * L) product
        q0 = U64(m) * l0
        q1 = U64(m) * l1
        q2 = U64(m) * l2
        t1 = (q0 >> _32) + (q1 & mask)
        t2 = (t1 >> _32) + (q1 >> _32) + (q2 & mask)
        return ((t2 >> _32) + (q2 >> _32)).astype(np.uint32)


def encode_lengths(lengths, n: int, variable_length: bool, batch: int) -> np.ndarray:
    """(batch,) int32 per-row length codes consumed by every multi-hash backend.

    code >= 0: variable-length row of L tokens -- mask tokens beyond L, place
      the paper's append-1 sentinel at position L, keep keys live through
      even(L+1) (so HM's odd-pad zero slot keeps its real key, DESIGN.md §3).
    code < 0 (encoded as -(n+1)): fixed-length row -- no sentinel, tokens
      masked beyond n, keys live through even(n).
    """
    if not variable_length:
        if lengths is not None:
            raise ValueError("lengths only apply with variable_length=True")
        return np.full(batch, -(n + 1), np.int32)
    if lengths is None:
        return np.full(batch, n, np.int32)
    lens = np.asarray(lengths, np.int64)
    if lens.shape != (batch,):
        raise ValueError(f"lengths shape {lens.shape} != ({batch},)")
    if (lens < 0).any() or (lens > n).any():
        raise ValueError(f"lengths must be in [0, {n}]")
    return lens.astype(np.int32)


def _mask_multi(s: np.ndarray, lens: np.ndarray):
    """(tok_eff u64 (B,N), live bool (B,N)) under the encode_lengths code."""
    B, N = s.shape
    col = np.arange(N, dtype=np.int64)[None, :]
    lens = lens.astype(np.int64)[:, None]
    is_var = lens >= 0
    lm = np.where(is_var, lens, -lens - 1)
    tok_eff = np.where(col < lm, s, np.where(is_var & (col == lm), 1, 0)).astype(U64)
    end = lm + is_var
    kend = end + (end & 1)  # ceil to even: HM pairs never straddle the mask
    return tok_eff, col < kend


def multilinear_multi_np(tokens: np.ndarray, lens: np.ndarray,
                         keys_u64: np.ndarray, family: str = "multilinear") -> np.ndarray:
    """K independent hashes of each row in one vectorized numpy pass.

    tokens: (B, N) uint32 (zero-padded); lens: (B,) int32 length codes
    (`encode_lengths`); keys_u64: (K, >= N+1) with m1 at column 0.
    Returns (B, K) uint64 full accumulators (>>32 for the 32-bit hash).

    This is the ground-truth oracle for the fused multi-hash kernel AND the
    single-item fast path (the k key windows are cached, one numpy pass --
    no per-probe key regeneration).
    """
    with np.errstate(over="ignore"):
        s = np.asarray(tokens).astype(U64)
        B, N = s.shape
        tok_eff, live = _mask_multi(s, lens)
        k = np.where(live[None, :, :], keys_u64[:, None, 1 : N + 1], U64(0))
        if family in ("multilinear", "multilinear_2x2"):
            acc = (k * tok_eff[None, :, :]).sum(axis=-1, dtype=U64)
        elif family == "multilinear_hm":
            if N % 2:
                raise ValueError("HM needs even padded N")
            a = k[..., 0::2] + tok_eff[None, :, 0::2]
            b = k[..., 1::2] + tok_eff[None, :, 1::2]
            acc = (a * b).sum(axis=-1, dtype=U64)
        else:
            raise ValueError(family)
        return (keys_u64[:, 0][:, None] + acc).T


_GF_POLY_LOW = np.uint64(0xC5)  # repro_torch.core.gf.POLY_LOW


def _clmul32_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized carry-less 32x32 -> 63-bit product in uint64 lanes.

    Same shifted partial-product plane decomposition as the kernel
    (`kernels/csrc/gf_multihash.cu::clmul32`), on numpy uint64 (the product
    fits 63 bits, so one limb suffices host-side). Inputs must hold
    values < 2^32.
    """
    a = np.asarray(a, U64)
    b = np.asarray(b, U64)
    acc = np.zeros(np.broadcast_shapes(a.shape, b.shape), U64)
    one = np.uint64(1)
    with np.errstate(over="ignore"):  # 0 - 1 wrap IS the all-ones mask
        for i in range(32):
            mask = np.uint64(0) - ((b >> np.uint64(i)) & one)
            acc ^= (a << np.uint64(i)) & mask
    return acc


def _gf_barrett_np(acc: np.ndarray) -> np.ndarray:
    """uint64 63-bit accumulators -> uint32 Barrett residues mod p(x)
    (the numpy twin of `core.gf.barrett_reduce`, on whole-u64 lanes)."""
    q1 = acc >> _32
    q2 = _clmul32_np(q1, _GF_POLY_LOW) ^ (q1 << _32)
    q3 = q2 >> _32
    f = _clmul32_np(q3, _GF_POLY_LOW) ^ (q3 << _32)
    return ((acc ^ f) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def gf_multilinear_multi_np(tokens: np.ndarray, lens: np.ndarray,
                            keys32: np.ndarray,
                            family: str = "gf_multilinear") -> np.ndarray:
    """K independent GF(2^32) hashes of each row in one vectorized pass.

    The carry-less twin of `multilinear_multi_np`: tokens (B, N) uint32
    (zero-padded); lens (B,) int32 length codes (`encode_lengths`, SAME
    masking algebra via `_mask_multi`); keys32 (K, >= N+1) uint32 32-bit
    keys (the LO plane of the u64 key streams) with m1 at column 0.
    Returns (B, K) uint64 of the engine's 64-bit GF surface
    ``h64 = (hash32 << 32) | acc_hi`` (DESIGN.md §11); >>32
    for the finished 32-bit hash.
    """
    s = np.asarray(tokens).astype(U64)
    B, N = s.shape
    tok_eff, live = _mask_multi(s, lens)
    k = np.where(live[None, :, :], keys32[:, None, 1 : N + 1].astype(U64),
                 U64(0))
    if family == "gf_multilinear":
        p = _clmul32_np(k, tok_eff[None, :, :])
    elif family == "gf_multilinear_hm":
        if N % 2:
            raise ValueError("HM needs even padded N")
        p = _clmul32_np(k[..., 0::2] ^ tok_eff[None, :, 0::2],
                        k[..., 1::2] ^ tok_eff[None, :, 1::2])
    else:
        raise ValueError(family)
    acc = np.bitwise_xor.reduce(p, axis=-1) ^ keys32[:, 0][:, None].astype(U64)
    h32 = _gf_barrett_np(acc)
    return ((h32.astype(U64) << _32) | (acc >> _32)).T


def python_int_oracle(tokens, keys, hm: bool = False) -> int:
    """Arbitrary-precision ground truth (mod 2^64 made explicit)."""
    mod = 1 << 64
    acc = int(keys[0])
    if hm:
        for i in range(len(tokens) // 2):
            acc += (int(keys[2 * i + 1]) + int(tokens[2 * i])) * (
                int(keys[2 * i + 2]) + int(tokens[2 * i + 1])
            )
    else:
        for i, t in enumerate(tokens):
            acc += int(keys[i + 1]) * int(t)
    return (acc % mod) >> 32
