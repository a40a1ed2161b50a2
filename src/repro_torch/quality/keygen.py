"""Input and key streams of the quality battery: Threefry-2x32 in PyTorch.

The port of `repro.quality.keygen`. Everything the battery hashes -- token
strings and the random key material of each sampled hash-function member
-- comes from a counter-based Threefry-2x32 stream: a pure function of
(seed, stream ids, shape), with no global generator, computed on the given
device. Distinct stream ids are folded into the base key, so the token
material, the key-hi planes and the key-lo planes are independent streams.

The bits are those of JAX's original Threefry layout (`jax.random` with
``jax_threefry_partitionable=False``): `threefry_2x32` hashes a flat
counter split into two halves (padded to an even count), `fold_in` hashes
the counter pair (0, data), and `random_bits` hashes the counters
0 .. size-1. The committed `QUALITY.json` was made with that layout, so
these streams reproduce its statistics on any device. One layout only.

A key is a pair of Python ints (k0, k1) of u32 values; it is derived on
the host (a handful of scalar rounds), and only the bulk streams run on the
device. Values are carried in int64 (PyTorch has no u32 add or shift on
the CPU), masked to 32 bits after every add and rotate.
"""
from __future__ import annotations

import math

import torch

from ..core.device import resolve_device
from ..core.limbs import MASK32

# Stream ids folded into the battery seed (disjoint from metric-local ids).
_TOKENS = 0
_KEY_HI = 1
_KEY_LO = 2
_PAIR = 3

#: The battery-wide base seed: QUALITY.json is a deterministic function of
#: this value (plus sizes).
QUALITY_SEED = 0x5AC1

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32_pair(k0: int, k1: int, x0, x1):
    """The 20-round Threefry-2x32 block function on counter words (x0, x1):
    Python ints or int64 tensors of u32 values. Returns the two output words
    in the same form."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def threefry_2x32(key, count: torch.Tensor) -> torch.Tensor:
    """JAX's `threefry_2x32(key, count)`: the flat counts are split into two
    halves (an odd count padded with one 0), hashed pairwise, and the two
    output halves concatenated (the pad's output dropped)."""
    flat = count.reshape(-1)
    n = flat.shape[0]
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.shape[0] // 2
    y0, y1 = threefry2x32_pair(*key, flat[:half], flat[half:])
    return torch.cat([y0, y1])[:n].reshape(count.shape)


def seed_key(seed: int) -> "tuple[int, int]":
    """`jax.random.PRNGKey(seed)`: the key (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    return seed >> 32, seed & MASK32


def fold_in(key, data: int) -> "tuple[int, int]":
    """`jax.random.fold_in(key, data)` with `data` taken as u32: the block
    function of the counter pair (0, data) under `key`."""
    data = int(data)
    if not 0 <= data < 1 << 32:
        raise ValueError(f"fold_in data {data} outside [0, 2^32)")
    return threefry2x32_pair(*key, 0, data)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` in the original layout: the
    block function over the counters 0 .. size-1, as int64 u32 values of
    `shape` on `device` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    size = math.prod(shape)
    if size >= MASK32:
        raise ValueError(f"{size} words need more than one Threefry block "
                         "of 2^32 - 1 counters")
    count = torch.arange(size, dtype=torch.int64, device=device)
    return threefry_2x32(key, count).reshape(shape)


def random_bits_at(key, size: int, index: torch.Tensor) -> torch.Tensor:
    """Elements `index` (int64 flat positions) of `random_bits(key, (size,))`
    without the others: element j is an output word of the counter pair
    (j, j + h) or (j - h, j), h half the (even-padded) size, whose pad
    counter is 0."""
    if size >= MASK32:
        raise ValueError(f"{size} words need more than one Threefry block "
                         "of 2^32 - 1 counters")
    half = (size + size % 2) // 2
    lo = index < half
    x0 = torch.where(lo, index, index - half)
    x1 = x0 + half
    x1 = torch.where(x1 < size, x1, torch.zeros_like(x1))
    y0, y1 = threefry2x32_pair(*key, x0, x1)
    return torch.where(lo, y0, y1)


def battery_key(seed: int = QUALITY_SEED, *ids: int) -> "tuple[int, int]":
    """Fold (seed, *ids) into a key: pure, collision-free derivation."""
    key = seed_key(seed)
    for i in ids:
        key = fold_in(key, i)
    return key


def token_batch(key, b: int, n: int, device=None) -> torch.Tensor:
    """(b, n) int64 u32 token rows -- b independent test strings."""
    return random_bits(fold_in(key, _TOKENS), (b, n), device)


def key_planes(key, b: int, m: int, device=None):
    """(hi, lo) int64 u32 (b, m) planes: b independent draws of m 64-bit key
    words -- one fresh hash-function member per sample row."""
    return (random_bits(fold_in(key, _KEY_HI), (b, m), device),
            random_bits(fold_in(key, _KEY_LO), (b, m), device))


def pair_partner(key, toks: torch.Tensor) -> torch.Tensor:
    """Independent second strings for the random-pair test: same shape and
    device as `toks`, disjoint stream."""
    return random_bits(fold_in(key, _PAIR), tuple(toks.shape), toks.device)
