"""Battery adapters: every registered `HashSpec` family, plus seeded
known-bad controls, as per-row-keyed PyTorch callables.

The port of `repro.quality.families`. The battery's contract is a function

    fn(toks (B, N), key_hi (B, M), key_lo (B, M)) -> (hi (B,), lo (B,))

over int64 tensors of u32 values, where row b is hashed by its OWN key
words (one fresh family member per sample -- strong universality is a claim
over the key draw), `hi` is the finished 32-bit hash, and `(hi, lo)` is the
family's full 64-bit surface for `acc64` families: the mod-2^64
accumulator for the integer families, and the engine's
``h64 = (hash32 << 32) | acc_hi`` packing for the GF ones. GF families
consume the lo plane only (32-bit carry-less keys).

A u64 is one int64 tensor here (its `*` and `+` wrap mod 2^64, see
`core.limbs`), so each adapter states its family's formula directly; the
values, and so the battery's counts, are the reference's.

Known-bad controls (the battery must flag both):

- `xor_folklore`: the paper's §4 counterexample family at word scale --
  XOR (not mod-2^64 sum) of the HM products.
- `multilinear_trunc16`: MULTILINEAR with positional keys truncated to 16
  bits (m1 left full width, so plain 1-D uniformity still passes).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import gf as gf_core
from ..core.limbs import MASK32, hi32, lo32
from ..hash import spec as hash_spec


@dataclasses.dataclass(frozen=True)
class BatteryFamily:
    """One battery entry: a family name, its per-row-keyed callable, and
    the traits the runner needs to size key material and pick metrics."""

    name: str
    fn: "object"          # (toks, khi, klo) -> (hi, lo), see module doc
    key_words: "object"   # n_tokens -> u64 key words per row
    acc64: bool           # (hi, lo) is the 64-bit surface
    known_bad: bool = False
    engine: bool = False  # constructible as a HashSpec/Hasher


def _u64(khi: torch.Tensor, klo: torch.Tensor) -> torch.Tensor:
    return (khi << 32) | klo


def _halves(acc: torch.Tensor):
    return hi32(acc), lo32(acc)


def multilinear(toks, khi, klo):
    """(m1 + sum m_{i+1} s_i) mod 2^64; keys (B, N+1), m1 at column 0."""
    k = _u64(khi, klo)
    return _halves((k[:, 1:] * toks).sum(1) + k[:, 0])


def multilinear_hm(toks, khi, klo):
    """(m1 + sum (m_{2i} + s_{2i-1})(m_{2i+1} + s_{2i})) mod 2^64."""
    k = _u64(khi, klo)
    p = (k[:, 1::2] + toks[:, 0::2]) * (k[:, 2::2] + toks[:, 1::2])
    return _halves(p.sum(1) + k[:, 0])


def _gf_surface(acc: torch.Tensor):
    """Raw 63-bit carry-less accumulator -> the engine's (hash32, acc_hi)."""
    return gf_core.barrett_reduce(acc), acc >> 32


def gf_multilinear(toks, khi, klo):
    """GF(2^32) MULTILINEAR: xor-accumulated carry-less products, Barrett-
    reduced mod p(x). 32-bit keys ride in the lo plane."""
    del khi
    acc = gf_core.xor_reduce(gf_core.clmul32(klo[:, 1:], toks))
    return _gf_surface(acc ^ klo[:, 0])


def gf_multilinear_hm(toks, khi, klo):
    """GF(2^32) MULTILINEAR-HM: (m_{2i} ^ s)(m_{2i+1} ^ s') pairing."""
    del khi
    p = gf_core.clmul32(klo[:, 1::2] ^ toks[:, 0::2], klo[:, 2::2] ^ toks[:, 1::2])
    return _gf_surface(gf_core.xor_reduce(p) ^ klo[:, 0])


def tree_multilinear(toks, khi, klo):
    """hash.tree's composition at battery scale: 2-token MULTILINEAR leaves
    (all leaves of a row share key words 0..2 -- m1, k1, k2 -- as a
    TreeHasher's leaves share one leaf Hasher) combined by the pairwise
    fold ``m1_l + f1*a_lo + f2*a_hi + f3*b_lo + f4*b_hi`` with 5 fresh key
    words per level; an odd trailing node is promoted unchanged. The
    length-tag finalization is a keyed affine shift of a constant at the
    battery's fixed N, so it is left out, as in the reference."""
    B, N = toks.shape
    k = _u64(khi, klo)
    t = toks.reshape(B, N // 2, 2)
    nodes = k[:, 1:2] * t[:, :, 0] + k[:, 2:3] * t[:, :, 1] + k[:, 0:1]
    off = 3
    while nodes.shape[1] > 1:
        P = nodes.shape[1] // 2
        m1, f1, f2, f3, f4 = (k[:, off + j:off + j + 1] for j in range(5))
        a, b = nodes[:, 0:2 * P:2], nodes[:, 1:2 * P:2]
        comb = (f1 * lo32(a) + f2 * hi32(a) + f3 * lo32(b) + f4 * hi32(b)
                + m1)
        nodes = torch.cat([comb, nodes[:, 2 * P:]], dim=1)
        off += 5
    return _halves(nodes[:, 0])


def _tree_key_words(n: int) -> int:
    """3 leaf words + 5 per fold level over n//2 leaves (8 at N_TOKENS=4)."""
    leaves = max(1, n // 2)
    return 3 + 5 * max(0, (leaves - 1).bit_length())


def xor_folklore(toks, khi, klo):
    """KNOWN BAD (paper §4): XOR of (k_{2i}+s_{2i})(k_{2i+1}+s_{2i+1})
    products -- 32-bit keys (lo plane), 32x32->64 products, xor-accumulated."""
    del khi
    a = (klo[:, 0::2] + toks[:, 0::2]) & MASK32
    b = (klo[:, 1::2] + toks[:, 1::2]) & MASK32
    return _halves(gf_core.xor_reduce(a * b))


def multilinear_trunc16(toks, khi, klo):
    """KNOWN BAD: MULTILINEAR with 16-bit positional keys (full-width m1)."""
    khi = torch.cat([khi[:, :1], torch.zeros_like(khi[:, 1:])], dim=1)
    klo = torch.cat([klo[:, :1], klo[:, 1:] & 0xFFFF], dim=1)
    return multilinear(toks, khi, klo)


_IMPLS = {
    # multilinear_2x2 is the same polynomial under a pair-blocked
    # evaluation order: identical values, so the battery evaluates the
    # shared formula -- its report row documents the identity.
    "multilinear": multilinear,
    "multilinear_2x2": multilinear,
    "multilinear_hm": multilinear_hm,
    "gf_multilinear": gf_multilinear,
    "gf_multilinear_hm": gf_multilinear_hm,
    "tree_multilinear": tree_multilinear,
}

# families whose key-word budget is not the default n + 1
_KEY_WORDS = {
    "tree_multilinear": _tree_key_words,
}


def battery_families() -> "list[BatteryFamily]":
    """Every registered `HashSpec` family (hash.spec.FAMILIES) followed by
    the seeded known-bad controls. The registry drives the sweep: a family
    added there without an adapter here is a loud KeyError."""
    out = []
    for name in hash_spec.registered_families():
        traits = hash_spec.FAMILIES[name]
        out.append(BatteryFamily(
            name=name, fn=_IMPLS[name],
            key_words=_KEY_WORDS.get(name, lambda n: n + 1),
            acc64=traits.acc64, engine=traits.engine))
    out.append(BatteryFamily(
        name="bad_xor_folklore", fn=xor_folklore,
        key_words=(lambda n: n), acc64=True, known_bad=True))
    out.append(BatteryFamily(
        name="bad_multilinear_trunc16", fn=multilinear_trunc16,
        key_words=(lambda n: n + 1), acc64=True, known_bad=True))
    return out
