"""GF(2^32) carry-less arithmetic on int64 tensors (paper §4, Appendix B).

The port's counterpart of `repro.core.gf`: the carry-less 32x32 -> 63-bit
product as 32 mask-and-xor steps and the 2-multiplication Barrett
reduction modulo p(x) = x^32 + x^7 + x^6 + x^2 + 1. A 63-bit product fits
one int64 lane, so no (hi, lo) limb pair is needed. Operands must hold
values in [0, 2^32).
"""
from __future__ import annotations

import torch

POLY_LOW = 0xC5  # 1 + x^2 + x^6 + x^7  (low part of p; bit 32 implied)
MASK32 = 0xFFFFFFFF


def clmul32(a, b) -> torch.Tensor:
    """Carry-less product of u32 values (int64 tensors or ints) -> int64.

    Shift-and-xor over the 32 bits of `b`; each partial product `a << i` is
    gated by bit i of `b`. `a << 31` < 2^63, so nothing wraps.
    """
    a = torch.as_tensor(a, dtype=torch.int64)
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.int64, device=a.device)
    for i in range(32):
        acc ^= (a << i) & -((b >> i) & 1)
    return acc


def clmul32_with_poly(a: torch.Tensor) -> torch.Tensor:
    """Carry-less product of `a` with the 33-bit p = 2^32 + POLY_LOW."""
    return clmul32(a, POLY_LOW) ^ (a << 32)


def barrett_reduce(acc: torch.Tensor) -> torch.Tensor:
    """63-bit carry-less accumulators (int64) -> residues mod p(x) in [0, 2^32).

        Q1 = q >> 32 ; Q2 = Q1 (*) p ; Q3 = Q2 >> 32
        r  = (q xor (Q3 (*) p)) mod 2^32
    Q2 has at most 63 bits, so its arithmetic shift needs no mask.
    """
    q3 = clmul32_with_poly(acc >> 32) >> 32
    return (acc ^ clmul32_with_poly(q3)) & MASK32
