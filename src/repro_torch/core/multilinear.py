"""The paper's hash families (Lemire & Kaser 2012, §2-§3) in plain PyTorch.

  MULTILINEAR       h(s) = (m1 + sum_i m_{i+1} s_i  mod 2^64) >> 32
  MULTILINEAR-2x2   identical value, pairwise-unrolled evaluation order
  MULTILINEAR-HM    h(s) = (m1 + sum_i (m_{2i}+s_{2i-1})(m_{2i+1}+s_{2i})
                            mod 2^64) >> 32          (n even)

The port of `repro.core.multilinear`. The reference works on (hi, lo)
uint32 limb pairs because the TPU has no 64-bit lanes; here a u64 lives in
one int64 tensor, whose `*` and `+` wrap mod 2^64 (see `core.limbs`).

Shapes: `tokens` is (..., n) u32 values (int32 ids are reinterpreted as
unsigned); `key_hi`/`key_lo` are (n+1,) u32 planes, key 0 is m1. Results
are (...,) int64 tensors holding u32 hashes. Tensor inputs stay on their
device; numpy inputs go to `core.device.resolve_device(device)`.

Variable-length strings follow the paper: append a character of value 1
(so no string ends in 0), then zero-pad -- for HM to an even length (§2).
"""
from __future__ import annotations

import torch

from . import limbs
from .device import as_u32_values, resolve_device
from .limbs import hi32


def _tokens(tokens, device) -> torch.Tensor:
    dev = tokens.device if isinstance(tokens, torch.Tensor) else resolve_device(device)
    return as_u32_values(tokens, dev)


def _keys(key_hi, key_lo, n: int, device) -> torch.Tensor:
    """The first n keys of the planes as one int64 tensor of u64 bits."""
    hi = as_u32_values(key_hi, device)[:n]
    lo = as_u32_values(key_lo, device)[:n]
    return (hi << 32) | lo


def _reduce_sum64(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum of u64 values (int64 bits) mod 2^64 along `axis` (int64 sums
    wrap, and the sum mod 2^64 does not depend on the order)."""
    return a.sum(dim=axis)


def multilinear(tokens, key_hi, key_lo, *, device=None):
    """h(s) = (m1 + sum m_{i+1} s_i mod 2^64) >> 32, batched over leading dims."""
    s = _tokens(tokens, device)
    n = s.shape[-1]
    k = _keys(key_hi, key_lo, n + 1, s.device)
    return hi32(_reduce_sum64(k[1:] * s, -1) + k[0])


def multilinear_2x2(tokens, key_hi, key_lo, *, device=None):
    """MULTILINEAR with 2-by-2 evaluation (Appendix A): same value as
    `multilinear`, summed two characters at a time."""
    s = _tokens(tokens, device)
    n = s.shape[-1]
    if n % 2:
        raise ValueError("2-by-2 requires even length (paper pads with 0)")
    k = _keys(key_hi, key_lo, n + 1, s.device)
    pair = k[1::2] * s[..., 0::2] + k[2::2] * s[..., 1::2]
    return hi32(_reduce_sum64(pair, -1) + k[0])


def multilinear_hm(tokens, key_hi, key_lo, *, device=None):
    """MULTILINEAR-HM (half the multiplications, Eq. 1 / Thm 3.1): n even,
    keys m_1..m_{n+1}."""
    s = _tokens(tokens, device)
    n = s.shape[-1]
    if n % 2:
        raise ValueError("MULTILINEAR-HM requires even length (paper pads with 0)")
    k = _keys(key_hi, key_lo, n + 1, s.device)
    prod = (k[1::2] + s[..., 0::2]) * (k[2::2] + s[..., 1::2])
    return hi32(_reduce_sum64(prod, -1) + k[0])


def multilinear_multiword(token_words, key_limbs, *, device=None):
    """MULTILINEAR with K = 32 * nlimbs bits, (nlimbs - 1) 32-bit input words
    per multiplication (the paper's __uint128 experiment, §5.5).

    token_words: (..., n_ops, nlimbs-1) u32 -- each row one character.
    key_limbs:   (n_ops + 1, nlimbs) u32 little-endian keys.
    Returns (...,) int64 holding the top 32 of the K bits.
    """
    s = _tokens(token_words, device)
    kl = as_u32_values(key_limbs, s.device)
    nlimbs, n_ops = kl.shape[-1], s.shape[-2]
    char = tuple(s[..., j] for j in range(nlimbs - 1)) + (torch.zeros_like(s[..., 0]),)
    keys = tuple(kl[1:n_ops + 1, j] for j in range(nlimbs))
    prod = limbs.mw_mul(keys, char)
    # Sum each limb over the ops (exact in int64 below 2^31 ops), then
    # carry once: the sum mod 2^(32 n) does not depend on the order.
    acc, carry = [], 0
    for limb in prod:
        t = limb.sum(dim=-1) + carry
        acc.append(t & limbs.MASK32)
        carry = t >> 32
    acc = limbs.mw_add(tuple(acc), tuple(kl[0, j] for j in range(nlimbs)))
    return limbs.mw_shr_to_top(acc)


def prepare_variable_length(tokens, length, max_len, family="multilinear", *,
                            device=None):
    """Append char value 1 at `length` (no string ends in 0), zero-pad to
    the row's width + 1 slot, and to an even padded length. Zero padding
    after the sentinel does not change the hash value (zero characters add
    m * 0 = 0). `max_len` and `family` are unused, as in the reference.

    tokens: (..., L) u32 values; length: (...,) ints.
    Returns (..., padded_len) int64 u32 values with padded_len even.
    """
    t = _tokens(tokens, device)
    L = t.shape[-1]
    padded = L + 1 if (L + 1) % 2 == 0 else L + 2
    length = torch.as_tensor(length, device=t.device).to(torch.int64)[..., None]
    out = torch.zeros((*t.shape[:-1], padded), dtype=torch.int64, device=t.device)
    out[..., :L] = torch.where(torch.arange(L, device=t.device) < length, t, 0)
    col = torch.arange(padded, device=t.device)
    return torch.where(col == length, 1, out)


FAMILIES = {
    "multilinear": multilinear,
    "multilinear_2x2": multilinear_2x2,
    "multilinear_hm": multilinear_hm,
}
