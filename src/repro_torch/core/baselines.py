"""Baseline string hashes the paper compares against (§5.6, Tables 3-4).

The port of `repro.core.baselines`, in plain PyTorch over (..., n) u32
token arrays (int64 tensors of u32 values; int32 ids are reinterpreted as
unsigned), like the Multilinear implementations:

  - Rabin-Karp (polynomial, B=31 like Java's String.hashCode): not universal.
  - SAX (shift-add-xor, Ramakrishna & Zobel): not universal.
  - NH (Black et al., UMAC): almost universal, 64-bit output from 32-bit
    chars, but not uniform.
  - FNV-1a: common non-universal baseline.
  - Zobrist: 3-wise independent table hashing for short strings (paper §1).

Tensor inputs stay on their device; numpy inputs go to
`device.resolve_device(device)` (the card unless ``device="cpu"``).
Results are int64 tensors holding u32 values.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import as_u32_values, resolve_device
from .gf import xor_reduce
from .limbs import MASK32, hi32, lo32


def _tokens(tokens, device) -> torch.Tensor:
    dev = tokens.device if isinstance(tokens, torch.Tensor) else resolve_device(device)
    return as_u32_values(tokens, dev)


def _scan(tokens, device, h0: int, step) -> torch.Tensor:
    """h = step(h, s_i) over the char axis, from h0 (the sequential
    dependence is intrinsic to these hashes)."""
    s = _tokens(tokens, device)
    h = torch.full(s.shape[:-1], h0, dtype=torch.int64, device=s.device)
    for i in range(s.shape[-1]):
        h = step(h, s[..., i])
    return h


def rabin_karp(tokens, base: int = 31, *, device=None) -> torch.Tensor:
    """h = ((..(s_1*B + s_2)*B + ...)*B + s_n) mod 2^32."""
    return _scan(tokens, device, 0, lambda h, x: (h * base + x) & MASK32)


def sax(tokens, *, device=None) -> torch.Tensor:
    """Shift-Add-Xor: h ^= (h << 5) + (h >> 2) + s_i (mod 2^32)."""
    return _scan(tokens, device, 0,
                 lambda h, x: h ^ (((h << 5) + (h >> 2) + x) & MASK32))


def fnv1a(tokens, *, device=None) -> torch.Tensor:
    """FNV-1a over the 4 bytes of each 32-bit char."""
    def step(h, x):
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((x >> shift) & 0xFF)) * 16777619) & MASK32
        return h
    return _scan(tokens, device, 2166136261, step)


def nh(tokens, key_lo, *, device=None):
    """NH (Black et al. 1999), §5.6:

        h = sum_i (m_{2i-1} + s_{2i-1} mod 2^32)(m_{2i} + s_{2i} mod 2^32)
            mod 2^64

    `key_lo`: (n,) u32 keys. Returns the (hi, lo) u32 halves of h.
    """
    s = _tokens(tokens, device)
    n = s.shape[-1]
    if n % 2:
        raise ValueError("NH pads odd strings with a zero char (paper §5.6)")
    k = as_u32_values(key_lo, s.device)[:n]
    a = (k[0::2] + s[..., 0::2]) & MASK32
    b = (k[1::2] + s[..., 1::2]) & MASK32
    acc = (a * b).sum(dim=-1)  # one 32x32 -> 64 product a pair, mod 2^64
    return hi32(acc), lo32(acc)


def nh_u64(tokens, key_lo, *, device=None) -> np.ndarray:
    """NH as numpy uint64 values."""
    hi, lo = nh(tokens, key_lo, device=device)
    return ((hi.cpu().numpy().astype(np.uint64) << np.uint64(32))
            | lo.cpu().numpy().astype(np.uint64))


class Zobrist:
    """Zobrist hashing (paper §1): 3-wise independent for short strings of
    few distinct characters; storage nc random words. The table is drawn
    from a Philox stream with numpy (the reference's bits) and gathered on
    the device."""

    def __init__(self, n_positions: int, alphabet: int, seed: int = 7,
                 bits: int = 32, *, device=None):
        rng = np.random.Generator(np.random.Philox(key=np.uint64(seed)))
        table = rng.integers(0, 2**bits, size=(n_positions, alphabet),
                             dtype=np.uint64).astype(np.uint32)
        self.table = as_u32_values(table, resolve_device(device))

    def __call__(self, tokens) -> torch.Tensor:
        s = as_u32_values(tokens, self.table.device)
        n = s.shape[-1]
        pos = torch.arange(n, device=s.device)
        return xor_reduce(self.table[pos, s])  # (..., n) gather per position
