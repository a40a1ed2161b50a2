"""The key stream of the Multilinear families, worked out from the seed.

A frozen copy of the key construction that the hashing library documents:
K independent streams of 64-bit keys, stream j seeded with
``seed ^ (j * 0x9E3779B97F4A7C15) mod 2^64``, each the counter-based
Philox-4x64 stream of numpy (key i is a pure function of the stream seed
and i). Column 0 of a stream is m1, column 1 + i multiplies token i.
numpy only; nothing here comes from the program under test.
"""
from __future__ import annotations

import numpy as np

GOLDEN64 = 0x9E3779B97F4A7C15
PHILOX_BLOCK = 4  # philox4x64 yields 4 u64 a counter step


def stream_seed(seed: int, j: int) -> int:
    """Base seed of stream j of a spec seeded with `seed`."""
    return (int(seed) ^ (j * GOLDEN64)) % (1 << 64)


def stream_keys(seed: int, count: int) -> np.ndarray:
    """The first `count` uint64 keys of the Philox stream of `seed`."""
    blocks = -(-count // PHILOX_BLOCK)
    gen = np.random.Generator(np.random.Philox(key=np.uint64(seed),
                                               counter=[0, 0, 0, 0]))
    return gen.integers(0, 2**64, size=blocks * PHILOX_BLOCK,
                        dtype=np.uint64)[:count]


def key_matrix(seed: int, n_hashes: int, width: int) -> np.ndarray:
    """(n_hashes, width) uint64: row j = the first `width` keys of stream j
    (m1 in column 0)."""
    return np.stack([stream_keys(stream_seed(seed, j), width)
                     for j in range(n_hashes)])
