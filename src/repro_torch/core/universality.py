"""Empirical (strong-)universality measurement (exhaustive + Monte Carlo).

The port's own copy of `repro.core.universality` (numpy and `Fraction`;
the Monte Carlo draws its keys from the port's `core.keys`). It validates
the paper's theorems and counterexamples:

- exhaustive joint-distribution checks of MULTILINEAR / MULTILINEAR-HM at
  small (K, L) -- Thm 3.1 says every (y, y') cell has probability exactly
  2^(2(L-K-1));
- the paper's numeric falsification of the "folklore" xor-family: strings
  (0,0) and (2,6) collide with probability 576/4096 > 1/8 at K=6, L=3;
- NH non-uniformity (§5.6): P(h=0) excess.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np


def _all_keys(K: int, n_keys: int):
    """Iterate the full key cube [0,2^K)^n_keys as a meshgrid of flat arrays."""
    vals = np.arange(1 << K, dtype=np.int64)
    grids = np.meshgrid(*([vals] * n_keys), indexing="ij")
    return [g.reshape(-1) for g in grids]


def multilinear_small(s, keys, K: int, L: int):
    """Generic small-K MULTILINEAR: ((m1 + sum m_{i+1} s_i) mod 2^K) >> (L-1)."""
    mod = 1 << K
    acc = keys[0].copy()
    for i, ch in enumerate(s):
        acc = acc + keys[i + 1] * int(ch)
    return (acc % mod) >> (L - 1)


def multilinear_hm_small(s, keys, K: int, L: int):
    mod = 1 << K
    if len(s) % 2:
        raise ValueError("MULTILINEAR-HM needs an even length")
    acc = keys[0].copy()
    for i in range(len(s) // 2):
        acc = acc + (keys[2 * i + 1] + int(s[2 * i])) * (keys[2 * i + 2] + int(s[2 * i + 1]))
    return (acc % mod) >> (L - 1)


def folklore_xor_small(s, keys, K: int, L: int):
    """The family the paper falsifies (§3): xor of products, >> L (not L-1),
    no m1 offset."""
    mod = 1 << K
    if len(s) % 2:
        raise ValueError("the folklore family needs an even length")
    acc = np.zeros_like(keys[0])
    for i in range(len(s) // 2):
        acc = acc ^ (((keys[2 * i] + int(s[2 * i])) * (keys[2 * i + 1] + int(s[2 * i + 1]))) % mod)
    return (acc % mod) >> L


def joint_distribution(family, s, s2, K: int, L: int, n_keys: int):
    """Exact joint histogram of (h(s), h(s')) over the full key cube.

    Returns (hist, n_total): hist[y, y'] = #key-tuples with h(s)=y, h(s')=y'.
    """
    keys = _all_keys(K, n_keys)
    h1 = family(s, keys, K, L)
    h2 = family(s2, keys, K, L)
    nvals = int(max(h1.max(), h2.max())) + 1
    hist = np.zeros((nvals, nvals), dtype=np.int64)
    np.add.at(hist, (h1, h2), 1)
    return hist, len(keys[0])


def check_strong_universality(family, s, s2, K: int, L: int, n_keys: int) -> Fraction:
    """Max |P(h(s)=y, h(s')=y') - 2^(2(L-K-1))| over all cells (exact Fractions).

    0 iff the family is strongly universal for this string pair.
    """
    hist, total = joint_distribution(family, s, s2, K, L, n_keys)
    nvals = 1 << (K - L + 1)
    target = Fraction(1, nvals * nvals)
    worst = Fraction(0)
    for y in range(nvals):
        for y2 in range(nvals):
            c = int(hist[y, y2]) if y < hist.shape[0] and y2 < hist.shape[1] else 0
            dev = abs(Fraction(c, total) - target)
            worst = max(worst, dev)
    return worst


def check_uniformity(family, s, K: int, L: int, n_keys: int) -> Fraction:
    """Max |P(h(s)=y) - 2^(L-K-1)| (strongly universal => 0)."""
    keys = _all_keys(K, n_keys)
    h = family(s, keys, K, L)
    total = len(keys[0])
    nvals = 1 << (K - L + 1)
    counts = np.bincount(h, minlength=nvals)
    target = Fraction(1, nvals)
    worst = Fraction(0)
    for y in range(nvals):
        worst = max(worst, abs(Fraction(int(counts[y]), total) - target))
    return worst


def collision_probability(family, s, s2, K: int, L: int, n_keys: int) -> Fraction:
    keys = _all_keys(K, n_keys)
    h1 = family(s, keys, K, L)
    h2 = family(s2, keys, K, L)
    return Fraction(int((h1 == h2).sum()), len(keys[0]))


def monte_carlo_collision(hash_fn, s, s2, n_trials: int, seed: int = 0) -> float:
    """Monte-Carlo collision rate of a full-width family over random keys
    (`hash_fn(tokens, key_hi, key_lo)` on numpy uint32 inputs); used where
    exhaustion is impossible."""
    from . import keys as keymod

    rng = np.random.Generator(np.random.Philox(key=np.uint64(seed)))
    coll = 0
    for _ in range(n_trials):
        kb = keymod.generate_keys_u64(int(rng.integers(2**63)), 0, max(len(s), len(s2)) + 1)
        hi, lo = keymod.split_hi_lo(kb)
        h1 = np.asarray(hash_fn(np.asarray(s, np.uint32), hi, lo))
        h2 = np.asarray(hash_fn(np.asarray(s2, np.uint32), hi, lo))
        coll += int(h1 == h2)
    return coll / n_trials
