"""Information-theoretic results the paper builds on (§3.2) + Prop 3.1 tools.

The PyTorch port's own copy of `repro.core.theory` (pure Python with
`Fraction`; the tree's collision bound and the quality battery use it).

- Stinson's bound: strongly universal hashing of M input bits to z output
  bits needs >= log2(1 + 2^M (2^z - 1)) random bits.
- MULTILINEAR uses K(n+1) = (z+L-1)(ceil(M/L)+1) random bits; the Stinson
  ratio -> 1 for the memory-optimal character size L* = sqrt((z-1) M / 2)
  (Eq. 4), while the compute-optimal size under cost K^a is L* = (z-1)/(a-1)
  (Eq. 5). These generate the paper's Fig. 1 / Fig. 2.
- Prop 3.1: (a x + c mod 2^K) // 2^(L-1) = b has exactly 2^(L-1) solutions
  x in [0, 2^K); exposed both constructively and by brute force for tests.
"""
from __future__ import annotations

import math
from fractions import Fraction


def stinson_random_bits(M: int, z: int) -> float:
    """log2(1 + 2^M (2^z - 1)) without overflow: ~= M + log2(2^z - 1)."""
    base = M + math.log2(2.0**z - 1.0)
    if M + z < 900:  # exact correction term while it is representable
        base += math.log2(1.0 + 1.0 / (2.0**M * (2.0**z - 1.0)))
    return base


def multilinear_random_bits(M: int, L: int, z: int, hm: bool = False) -> int:
    """Random bits used by MULTILINEAR (-HM) hashing M input bits with L-bit
    chars to z usable bits: K = z + L - 1, n = ceil(M/L) chars (+1 pad to
    even for HM), keys m_1..m_{n+1}."""
    n = -(-M // L)
    if hm and n % 2:
        n += 1
    K = z + L - 1
    return K * (n + 1)


def stinson_ratio(M: int, L: int, z: int, hm: bool = False) -> float:
    return multilinear_random_bits(M, L, z, hm) / stinson_random_bits(M, z)


def optimal_L_memory(M: int, z: int) -> float:
    """Eq. 4: L* = sqrt((z-1) M / 2) minimizes random-bit usage."""
    return math.sqrt((z - 1) * M / 2.0)


def optimal_L_compute(z: int, a: float) -> float:
    """Eq. 5: L* = (z-1)/(a-1) minimizes (z+L-1)^a / L (cost per input bit
    under superlinear multiplication cost K^a)."""
    return (z - 1) / (a - 1)


def compute_cost_per_bit(L: float, z: int, a: float) -> float:
    """Fig. 2 model: (z + L - 1)^a / L."""
    return (z + L - 1) ** a / L


def trailing_zeros(a: int) -> int:
    assert a != 0
    return (a & -a).bit_length() - 1


def prop31_solution_count(K: int, L: int) -> int:
    """Exactly 2^(L-1) solutions (Prop 3.1), independent of a, b, c."""
    return 2 ** (L - 1)


def prop31_solve_brute(a: int, b: int, c: int, K: int, L: int) -> list[int]:
    """All x in [0, 2^K) with ((a*x + c) mod 2^K) // 2^(L-1) == b."""
    out = []
    mod = 1 << K
    shift = L - 1
    for x in range(mod):
        if ((a * x + c) % mod) >> shift == b:
            out.append(x)
    return out


def prop31_solve_constructive(a: int, b: int, c: int, K: int, L: int) -> list[int]:
    """Solutions via the proof of Prop 3.1 (used to cross-check brute force):
    strip tau = trailing(a) zeros, invert the odd part mod 2^(K-tau),
    enumerate the 2^(L-1-tau) admissible z and 2^tau lifts of x'."""
    tau = trailing_zeros(a)
    assert tau <= L - 1
    a_ = a >> tau
    c_ = c >> tau
    Kt = K - tau
    modt = 1 << Kt
    inv = pow(a_, -1, modt)
    out = []
    for z in range(b << (L - 1 - tau), (b + 1) << (L - 1 - tau)):
        x_ = (inv * ((z - c_) % modt)) % modt
        for lift in range(1 << tau):
            out.append(x_ + (lift << Kt))
    return sorted(out)


def exact_pairwise_prob(K: int, L: int) -> Fraction:
    """Thm 3.1 target joint probability P(h(s)=y, h(s')=y') = 2^(2(L-K-1))."""
    return Fraction(1, 2 ** (2 * (K - L + 1)))


# -- tree composition (hash.tree, DESIGN.md section 10) -----------------------

def tree_eps_level(char_bits: int = 32, acc_bits: int = 64) -> Fraction:
    """Per-level collision bound of a MULTILINEAR compression mod 2^acc_bits
    over char_bits-bit characters: two distinct equal-length inputs collide
    iff sum k_i * d_i = delta (mod 2^acc) for the nonzero difference vector
    d; fixing all keys but one with d_j != 0, k_j * d_j must hit a fixed
    residue, which has 2^v solutions for v = trailing_zeros(d_j) <= char_bits
    - 1.  Hence eps <= 2^(char_bits-1) / 2^acc_bits = 2^-(acc-char+1)."""
    return Fraction(1, 2 ** (acc_bits - char_bits + 1))


def tree_depth(n_leaves: int) -> int:
    """Fold levels of an n-leaf tree: ceil(log2(n)) pairwise levels."""
    if n_leaves < 1:
        raise ValueError("n_leaves must be >= 1")
    return max(0, (n_leaves - 1).bit_length())


def tree_collision_bound(n_leaves: int, char_bits: int = 32,
                         acc_bits: int = 64) -> Fraction:
    """Collision bound of the full tree digest on two distinct streams:
    union bound over the leaf level, the tree_depth(n) fold levels, and the
    length-tag finalization -- each an independent-key strongly-universal
    compression, so errors only add (the HalftimeHash composition argument,
    arXiv 2104.08865):  (depth + 2) * eps_level.  For 64-bit accumulators
    and 32-bit characters this is (depth + 2) * 2^-33 -- under 2^-27 even
    at a billion leaves."""
    return (tree_depth(n_leaves) + 2) * tree_eps_level(char_bits, acc_bits)
