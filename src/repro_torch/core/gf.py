"""GF(2^32) carry-less arithmetic on int64 tensors (paper §4, Appendix B).

The port's counterpart of `repro.core.gf`: the carry-less 32x32 -> 63-bit
product as 32 mask-and-xor steps and the 2-multiplication Barrett
reduction modulo p(x) = x^32 + x^7 + x^6 + x^2 + 1, the whole-string GF
MULTILINEAR(-HM) hashes on top of them, and the Python-int ground truths
the tests hold them against. A 63-bit product fits one int64 lane, so no
(hi, lo) limb pair is needed. Operands must hold values in [0, 2^32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .device import as_u32_values, resolve_device

POLY_LOW = 0xC5  # 1 + x^2 + x^6 + x^7  (low part of p; bit 32 implied)
POLY_FULL_INT = (1 << 32) | POLY_LOW
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


def _operands(tokens, keys32, device):
    """Tokens and keys as int64 u32 values: tensor tokens stay on their
    device, numpy ones go to `resolve_device(device)`."""
    dev = tokens.device if isinstance(tokens, torch.Tensor) else resolve_device(device)
    return as_u32_values(tokens, dev), as_u32_values(keys32, dev)


def gf_multilinear(tokens, keys32, *, device=None) -> torch.Tensor:
    """GF MULTILINEAR (Eq. 6): xor-accumulate m_{i+1} (*) s_i, Barrett at end.

    tokens: (..., n) u32; keys32: (n+1,) u32. Returns (...,) int64 u32 hashes.
    """
    s, k = _operands(tokens, keys32, device)
    n = s.shape[-1]
    return barrett_reduce(xor_reduce(clmul32(k[1:n + 1], s)) ^ k[0])


def gf_multilinear_hm(tokens, keys32, *, device=None) -> torch.Tensor:
    """GF MULTILINEAR-HM: half the carry-less products, with XOR as the GF(2)
    addition in the pairing (m_{2i} ^ s_{2i-1}) (*) (m_{2i+1} ^ s_{2i})."""
    s, k = _operands(tokens, keys32, device)
    n = s.shape[-1]
    if n % 2:
        raise ValueError("GF MULTILINEAR-HM needs an even length")
    k = k[:n + 1]
    a = k[1::2] ^ s[..., 0::2]
    b = k[2::2] ^ s[..., 1::2]
    return barrett_reduce(xor_reduce(clmul32(a, b)) ^ k[0])


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """xor along the last axis, in pairwise folds (xor is exact in any order)."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    while x.shape[-1] > 1:
        if x.shape[-1] & 1:
            x = F.pad(x, (0, 1))
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


# ---------------------------------------------------------------------------
# Python-int ground truths for tests
# ---------------------------------------------------------------------------

def clmul_ref(a: int, b: int) -> int:
    """Bit-at-a-time carry-less product over python ints (ground truth)."""
    acc = 0
    i = 0
    while b >> i:
        if (b >> i) & 1:
            acc ^= a << i
        i += 1
    return acc


def poly_mod_ref(q: int, p: int = POLY_FULL_INT) -> int:
    """Naive GF(2)[x] long division remainder (ground truth)."""
    dp = p.bit_length() - 1
    while q.bit_length() - 1 >= dp and q:
        q ^= p << (q.bit_length() - 1 - dp)
    return q


def _acc_ref(tokens, keys32, hm: bool) -> int:
    """The raw carry-less accumulator over python ints: m1 xor the products
    (HM: of the XOR-paired key and token words, floor(n / 2) pairs)."""
    acc = int(keys32[0])
    if hm:
        for i in range(len(tokens) // 2):
            acc ^= clmul_ref(int(keys32[2 * i + 1]) ^ int(tokens[2 * i]),
                             int(keys32[2 * i + 2]) ^ int(tokens[2 * i + 1]))
    else:
        for i, t in enumerate(tokens):
            acc ^= clmul_ref(int(keys32[i + 1]), int(t))
    return acc


def gf_multilinear_ref(tokens, keys32) -> int:
    """Ground-truth GF Multilinear over python ints."""
    return poly_mod_ref(_acc_ref(tokens, keys32, hm=False))


def gf_multilinear_hm_ref(tokens, keys32) -> int:
    """Ground-truth GF Multilinear-HM over python ints (XOR pairing)."""
    if len(tokens) % 2:
        raise ValueError("GF MULTILINEAR-HM needs an even length")
    return poly_mod_ref(_acc_ref(tokens, keys32, hm=True))


def gf_h64_ref(tokens, keys32, hm: bool = False) -> int:
    """Ground truth of the engine's 64-bit GF surface (python ints):
    ``h64 = (hash32 << 32) | acc_hi``, hash32 the Barrett-reduced
    accumulator and acc_hi its hi limb -- bijective with the raw 63-bit
    accumulator, so ``h64 >> 32`` is the paper's finished 32-bit hash."""
    acc = _acc_ref(tokens, keys32, hm)
    return (poly_mod_ref(acc) << 32) | (acc >> 32)
