"""Random-key management for the Multilinear families.

The paper's main cost caveat (§6) is the buffer of random numbers: strongly
universal hashing of n-character strings *requires* ~K(n+1) random bits
(Stinson's bound, §3.2), so keys must be generated, stored, streamed, and --
for "unexpectedly long strings" -- extended on demand.

We use a counter-based construction (Philox via numpy): key i is a pure
function of (seed, i), so extension never re-generates earlier keys and the
host and device paths agree bit-exactly. This module is the PyTorch port's
own copy of `repro.core.keys` (numpy only; the two produce identical bits by
construction). `repro_torch.hash.Hasher` uploads the stacked planes to the
device once as a (K, cap+1) int64 tensor of u64 key bits.
"""
from __future__ import annotations

import numpy as np

_PHILOX_BLOCK = 4  # philox4x64 emits 4 u64 per counter tick


def generate_keys_u64(seed: int, start: int, count: int) -> np.ndarray:
    """Deterministic uint64 keys m_start .. m_{start+count-1} for `seed`.

    Pure function of (seed, index): slicing [start, start+count) out of the
    infinite Philox stream, so on-demand extension (paper §6) is O(count).
    """
    # Philox counter starts at block `start // 4`; generate enough blocks.
    first_block = start // _PHILOX_BLOCK
    last_block = (start + count + _PHILOX_BLOCK - 1) // _PHILOX_BLOCK
    nblocks = last_block - first_block
    bitgen = np.random.Philox(key=np.uint64(seed), counter=[first_block, 0, 0, 0])
    gen = np.random.Generator(bitgen)
    raw = gen.integers(0, 2**64, size=nblocks * _PHILOX_BLOCK, dtype=np.uint64)
    off = start - first_block * _PHILOX_BLOCK
    return raw[off : off + count]


def planes_to_keys(key_hi: np.ndarray, key_lo: np.ndarray) -> np.ndarray:
    """(..., n) uint32 hi/lo planes -> (..., n) int64 array of the u64 bits
    (the port's key tensors carry u64 keys in int64)."""
    hi = np.asarray(key_hi, np.uint32).astype(np.uint64)
    lo = np.asarray(key_lo, np.uint32).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def split_hi_lo(keys_u64: np.ndarray):
    """uint64 keys -> (hi, lo) uint32 planes (little-endian limbs)."""
    hi = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    lo = (keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


class KeyBuffer:
    """Growable deterministic buffer of 64-bit keys.

    `ensure(n)` guarantees keys m_1..m_n exist (index 0 is m_1). Growth is
    amortized-doubling so hashing a stream of unknown length costs O(total)
    key generation, per the paper's §6 recommendation.
    """

    def __init__(self, seed: int = 0x5EED, initial: int = 4096):
        self.seed = int(seed)
        self._keys = generate_keys_u64(self.seed, 0, initial)

    def __len__(self) -> int:
        return len(self._keys)

    def ensure(self, n: int) -> None:
        cur = len(self._keys)
        if n <= cur:
            return
        new = max(n, cur * 2)
        extra = generate_keys_u64(self.seed, cur, new - cur)
        self._keys = np.concatenate([self._keys, extra])

    def u64(self, n: int) -> np.ndarray:
        self.ensure(n)
        return self._keys[:n]

    def hi_lo(self, n: int):
        return split_hi_lo(self.u64(n))


_GOLDEN64 = 0x9E3779B97F4A7C15  # splitmix/Fibonacci increment for stream derivation


def derive_stream_seed(seed: int, j: int) -> int:
    """Seed of the j-th independent key stream for base `seed` (j=0 -> seed).

    Stream 0 is the base KeyBuffer's own Philox stream, so K=1 users see the
    exact keys a plain ``KeyBuffer(seed)`` would produce; streams j>0 are
    distinct counter-based streams, never overlapping windows of one stream
    (the seed BloomFilter's overlapping-window construction regenerated
    O(k*n) keys per lookup AND made key values depend on item length).
    """
    return (int(seed) ^ (j * _GOLDEN64)) % (1 << 64)


class MultiKeyBuffer:
    """K independent growable key streams = K independent hash functions.

    Each stream follows the paper's convention: u64[0] is m1, u64[1:] are the
    positional keys. All windows are materialized once at construction and
    grown on demand (amortized doubling via KeyBuffer), so per-lookup key
    regeneration is gone entirely.

    `seeds` gives explicit per-stream base seeds (e.g. the data pipeline's
    dedup/split/shard salts fused into one engine pass); otherwise streams
    are derived from `seed` via `derive_stream_seed`.
    """

    def __init__(self, seed: int = 0x5EED, n_hashes: int = 1,
                 seeds: "list[int] | None" = None, initial: int = 256):
        if seeds is not None:
            self.seeds = [int(s) for s in seeds]
        else:
            self.seeds = [derive_stream_seed(seed, j) for j in range(n_hashes)]
        self.buffers = [KeyBuffer(seed=s, initial=initial) for s in self.seeds]
        # streams are append-only pure functions of (seed, i), so a stacked
        # prefix of width n is immutable: memoize per n (widths are pow2-
        # bucketed by the engine, so this stays a handful of entries)
        self._stacked: dict[int, np.ndarray] = {}
        self._planes: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def n_hashes(self) -> int:
        return len(self.buffers)

    def stacked_u64(self, n: int) -> np.ndarray:
        """(K, n) uint64: row j = first n keys of stream j (m1 at column 0)."""
        out = self._stacked.get(n)
        if out is None:
            out = np.stack([kb.u64(n) for kb in self.buffers])
            out.setflags(write=False)  # shared across callers
            self._stacked[n] = out
        return out

    def planes(self, n: int):
        """(hi, lo) uint32 (K, n) planes of `stacked_u64(n)`."""
        out = self._planes.get(n)
        if out is None:
            hi, lo = split_hi_lo(self.stacked_u64(n))
            hi.setflags(write=False)
            lo.setflags(write=False)
            out = self._planes[n] = (hi, lo)
        return out
