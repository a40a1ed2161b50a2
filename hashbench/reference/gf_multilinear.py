"""GF(2^32) Multilinear (Lemire & Kaser 2012, Sec. 4), plain.

acc = m1 xor (xor_i clmul(key[1 + i], s_i)), with the low 32 bits of each
key, over the row's string with its sentinel (a 63-bit polynomial);
h32 = acc mod p(x), p = x^32 + x^7 + x^6 + x^2 + 1, by long division bit
by bit; the 64-bit surface is (h32 << 32) | (acc >> 32).
"""
from __future__ import annotations

import torch

from .common import MASK32, terminated

POLY = (1 << 32) | 0xC5  # x^32 + x^7 + x^6 + x^2 + 1


def clmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-less product of u32 values held in int64: bit i of b selects
    a << i (below 2^63, so nothing reaches the sign bit)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.int64, device=a.device)
    for i in range(32):
        acc ^= (a << i) * ((b >> i) & 1)
    return acc


def poly_mod(acc: torch.Tensor) -> torch.Tensor:
    """63-bit polynomials mod p(x), one bit at a time from the top."""
    for i in range(62, 31, -1):
        acc = acc ^ (((acc >> i) & 1) * (POLY << (i - 32)))
    return acc


def _acc(tokens, lengths, keys) -> torch.Tensor:
    tok = terminated(tokens, lengths)
    cols = tok.shape[1]
    out = torch.empty((tok.shape[0], keys.shape[0]), dtype=torch.int64,
                      device=tok.device)
    for k in range(keys.shape[0]):
        x = clmul32(keys[k, 1:cols + 1] & MASK32, tok)
        while x.shape[1] > 1:  # xor is exact in any order: fold in halves
            if x.shape[1] % 2:
                x = torch.nn.functional.pad(x, (0, 1))
            x = x[:, 0::2] ^ x[:, 1::2]
        out[:, k] = x[:, 0] ^ (keys[k, 0] & MASK32)
    return out


def surface(tokens, lengths, keys) -> torch.Tensor:
    """(R, N) tokens, (R,) lengths, (K, >= N + 2) int64 keys holding u64
    bits -> (R, K) int64 holding each row's K surfaces."""
    acc = _acc(tokens, lengths, keys)
    return (poly_mod(acc) << 32) | (acc >> 32)


def hash32(tokens, lengths, keys) -> torch.Tensor:
    """(R, K) int64 32-bit hashes: the accumulator mod p(x)."""
    return poly_mod(_acc(tokens, lengths, keys))
