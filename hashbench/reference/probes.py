"""Bloom probes: a 64-bit surface mod m, and the filter's size.

`mod_u64` works on 16-bit digits (Horner), so every intermediate stays
below 2^48 and the signed `%` of int64 is exact for surfaces at or above
2^63. `bloom_size` is the textbook sizing of a Bloom filter for n items at
a false-positive rate p: m = floor(-n ln p / ln^2 2) bits (at least 64)
and k = floor(m / n ln 2) probes (at least 1).
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def mod_u64(x: torch.Tensor, m: int) -> torch.Tensor:
    """u64 values held in int64 mod a modulus m in [1, 2^32) -> int64."""
    if not 1 <= m < 1 << 32:
        raise ValueError(f"modulus {m} outside [1, 2^32)")
    lo = x & MASK32
    r = ((x >> 32) & MASK32) % m
    r = ((r << 16) | (lo >> 16)) % m
    return ((r << 16) | (lo & 0xFFFF)) % m


def bloom_size(n_items: int, fp_rate: float) -> tuple[int, int]:
    """(m bits, k probes) of a Bloom filter for n_items at fp_rate."""
    m = max(64, int(-n_items * math.log(fp_rate) / (math.log(2) ** 2)))
    return m, max(1, int(m / n_items * math.log(2)))
