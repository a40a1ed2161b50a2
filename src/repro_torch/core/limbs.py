"""64-bit integer helpers on int64 tensors that carry u64 bits.

PyTorch has no arithmetic on `torch.uint32`/`torch.uint64` on the CPU, so
the port carries every 32-bit lane and every 64-bit accumulator in int64:

- int64 `*` and `+` wrap mod 2^64, which is exactly the integer families'
  accumulator ring;
- `>>` on int64 is arithmetic (it copies the sign bit), so every right
  shift is followed by a 32-bit mask;
- `%` on int64 is floor-mod on the SIGNED value, so a u64 at or above 2^63
  would reduce wrongly. `mod_u64` therefore works on 32-bit limbs, keeping
  every intermediate below 2^63.

The reference does this with (hi, lo) uint32 limb pairs and a 16-bit digit
trick because the TPU has no 64-bit lanes (`repro.core.limbs`); the CUDA
kernels use native `uint64_t` and a host reciprocal instead. So the
reference's `mul32_full`, `add64`, `add64_u32`, `mul64_low` and `mul64_u32`
are plain int64 `*` and `+` here (a 32x32 product's u64 bits are `a * b`),
and the Lemire reduction `(h * nb) >> 32` is `mulhi32`.
"""
from __future__ import annotations

import dataclasses

import torch

MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ModPlan:
    """A validated 32-bit modulus for `mod_u64` and the kernels' `mod_m`.

    The reference's plan also carries a 96-bit Barrett reciprocal for its
    32-bit limb arithmetic. The port's plan is the modulus and its
    power-of-two flag: the engine kernels get their own 64-bit reciprocal
    floor((2^64 - 1) / m) from the C launcher on the host
    (`csrc/engine_tile.cuh::mod_by`), and the plain version reduces in
    16-bit Horner steps (`mod_u64`).
    """

    m: int
    is_pow2: bool

    @classmethod
    def for_modulus(cls, m: int) -> "ModPlan":
        m = int(m)
        if not 1 <= m < 1 << 32:
            raise ValueError(f"modulus {m} outside the 32-bit domain [1, 2^32)")
        return cls(m=m, is_pow2=m & (m - 1) == 0)


def as_plan(mod_m) -> "ModPlan | None":
    """None, an int modulus or a `ModPlan` -> `ModPlan | None`."""
    if mod_m is None or isinstance(mod_m, ModPlan):
        return mod_m
    return ModPlan.for_modulus(mod_m)


def hi32(x: torch.Tensor) -> torch.Tensor:
    """Top 32 bits of u64 values held in int64, as int64 in [0, 2^32)."""
    return (x >> 32) & MASK32


def lo32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of u64 values held in int64, as int64 in [0, 2^32)."""
    return x & MASK32


def mod_u64(h: torch.Tensor, plan) -> torch.Tensor:
    """u64 values (int64 bits) mod a 32-bit m -> int64 residues in [0, m).

    Horner over 16-bit digits: r = hi mod m, then twice r = (r*2^16 + d) mod
    m for the next 16-bit digit d of lo. Every intermediate is < m*2^16 +
    2^16 < 2^48, so the signed `%` is exact.
    """
    plan = as_plan(plan)
    if plan.is_pow2:
        return h & (plan.m - 1)
    m = plan.m
    lo = lo32(h)
    r = hi32(h) % m
    r = ((r << 16) | (lo >> 16)) % m
    return ((r << 16) | (lo & 0xFFFF)) % m


def mulhi32(a: torch.Tensor, b: int) -> torch.Tensor:
    """High half of the 32x32 -> 64 product of u32 values a (int64) and b.

    With a < 2^32 and 0 <= b < 2^31 the product stays below 2^63, so one
    int64 multiply is exact (the reference's `limbs.mul32_full` high half).
    """
    if not 0 <= b < 1 << 31:
        raise ValueError(f"multiplier {b} outside [0, 2^31)")
    return (a * b) >> 32


def unpack_bits32(x: torch.Tensor) -> torch.Tensor:
    """(...,) u32 values (int64) -> (..., 32) int64 bit planes, LSB first."""
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return (x[..., None] >> shifts) & 1


# ---------------------------------------------------------------------------
# Little-endian multiword values (K = 32 n bits, paper §3.2 / §5.5): tuples
# of n int64 tensors, each holding one u32 limb.
# ---------------------------------------------------------------------------

def mw_add(a, b):
    """Multiword add mod 2^(32n) of two limb tuples."""
    out, carry = [], 0
    for x, y in zip(a, b):
        s = x + y + carry  # < 2^33 + 1: exact in int64
        out.append(s & MASK32)
        carry = s >> 32
    return tuple(out)


def mw_add_u32(a, x):
    """Multiword add mod 2^(32n) of a limb tuple and one u32 value."""
    out, carry = [], x
    for limb in a:
        s = limb + carry
        out.append(s & MASK32)
        carry = s >> 32
    return tuple(out)


def mw_mul(a, b):
    """Multiword schoolbook product mod 2^(32n) of two limb tuples.

    The 32x32 -> 64 partial product wraps in int64, but its bits are the
    u64 product; each column sum acc + lo + carry stays below 3 * 2^32 and
    each carry below 2^32, so every step is exact.
    """
    n = len(a)
    acc = [torch.zeros_like(a[0]) for _ in range(n)]
    for i in range(n):
        carry = torch.zeros_like(a[0])
        for j in range(n - i):
            p = a[i] * b[j]
            s = acc[i + j] + (p & MASK32) + carry
            acc[i + j] = s & MASK32
            carry = hi32(p) + (s >> 32)
    return tuple(acc)


def mw_shr_to_top(a, z_bits: int = 32):
    """The top 32-bit limb: the multiword value >> (32n - 32)."""
    return a[-1]
