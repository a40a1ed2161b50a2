"""Hash-quality metrics on tensors, with thresholds derived from the exact
null distributions.

The port of `repro.quality.metrics`. The measurements run as PyTorch
operations on the device of their inputs (int64 tensors of u32 values):

- `avalanche_bic`     -- flip-probability matrix over every input bit x
                         output bit, plus the bit-independence criterion
                         (max |corr| between output-bit flips), one pass
                         per input bit.
- `bucket_counts`     -- Lemire `(h*nb) >> 32` bucket histogram of 32-bit
                         hashes (bias-free range reduction).
- `mod_bucket_counts` -- histogram of `acc mod m` residues through the same
                         reduction as the engine's probe path
                         (`limbs.mod_u64`), coarse-bucketed for huge m.
- `collision_count` / `joint_counts` -- pair-collision and joint
                         (h(x), h(x')) occupancy for the strong-universality
                         estimator.

The threshold helpers are host-side closed forms (no scipy), copied from
the reference: strong universality makes every null distribution exact
(each avalanche cell is Binomial(B, 1/2); bucket counts give a chi^2_{nb-1}
statistic; pair collisions on the 32-bit output are Binomial(B, 2^-32)), so
thresholds are quantiles of those distributions at a familywise level:

- normal quantiles via bisection on `math.erfc`;
- chi^2 quantiles via the Wilson-Hilferty cube-root normal approximation;
- Binomial tail probabilities summed exactly in log space (`math.lgamma`).

All "max over C cells" metrics use the Sidak correction: the per-cell level
for familywise alpha over C independent cells is 1 - (1-alpha)^(1/C).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import limbs

#: Familywise significance per metric instance.
ALPHA = 1e-6
#: Pair-collision alpha is tighter: the statistic is a tiny count where each
#: unit step crosses decades of tail probability.
ALPHA_COLLISION = 1e-9


# ---------------------------------------------------------------------------
# Distribution helpers (host-side, closed-form)
# ---------------------------------------------------------------------------

def normal_sf(z: float) -> float:
    """P(Z > z) for standard normal Z (double-precision erfc)."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def normal_quantile_sf(p: float) -> float:
    """z with P(Z > z) = p, by bisection on the monotone `normal_sf`."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"tail probability must be in (0, 1), got {p}")
    lo, hi = -42.0, 42.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if normal_sf(mid) > p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def chi2_sigma(stat: float, df: int) -> float:
    """Equivalent normal z of a chi^2_{df} statistic (Wilson-Hilferty):
    (X/df)^(1/3) is approximately N(1 - 2/(9df), 2/(9df))."""
    if df < 1:
        raise ValueError(f"df must be >= 1, got {df}")
    v = 2.0 / (9.0 * df)
    return ((max(stat, 0.0) / df) ** (1.0 / 3.0) - (1.0 - v)) / math.sqrt(v)


def chi2_bound(df: int, alpha: float = ALPHA) -> float:
    """Upper-tail chi^2_{df} quantile at level `alpha` (Wilson-Hilferty
    inverse): the PASS threshold for a bucket-uniformity statistic."""
    z = normal_quantile_sf(alpha)
    v = 2.0 / (9.0 * df)
    return df * (1.0 - v + z * math.sqrt(v)) ** 3


def sidak_cell_z(n_cells: int, alpha: float = ALPHA) -> float:
    """Two-sided per-cell z threshold so that the max over `n_cells`
    independent cells exceeds it with probability `alpha`."""
    per_cell = 1.0 - (1.0 - alpha) ** (1.0 / n_cells)
    return normal_quantile_sf(per_cell / 2.0)


def binom_logsf(k: int, n: int, p: float) -> float:
    """log10 P(X >= k) for X ~ Binomial(n, p), summed exactly in log space;
    summation stops when the remaining geometric tail is below 1e-12
    relative."""
    if k <= 0:
        return 0.0
    if k > n:
        return -math.inf
    lp, lq = math.log(p), math.log1p(-p)

    def logpmf(i: int) -> float:
        return (math.lgamma(n + 1) - math.lgamma(i + 1)
                - math.lgamma(n - i + 1) + i * lp + (n - i) * lq)

    total = -math.inf
    for i in range(k, n + 1):
        t = logpmf(i)
        total = max(total, t) + math.log1p(math.exp(-abs(total - t)))
        # ratio of successive terms: ((n-i)/(i+1)) * p/q
        r = (n - i) / (i + 1) * p / math.exp(lq)
        if r < 1.0 and t - total < math.log(1e-12 * (1.0 - r)):
            break
    return total / math.log(10.0)


def binom_crit(n: int, p: float, alpha: float = ALPHA_COLLISION) -> int:
    """Smallest k with P(Binomial(n,p) >= k) <= alpha: observing >= k is a
    significance-alpha rejection of the ideal collision rate."""
    log_alpha = math.log10(alpha)
    k = max(1, int(n * p))
    while binom_logsf(k, n, p) > log_alpha:
        k += 1
    return k


def chi2_stat(counts, expected) -> float:
    """Pearson chi^2 of observed `counts` against `expected` (scalar or
    per-bucket array of the same length)."""
    c = np.asarray(counts, np.float64)
    e = np.broadcast_to(np.asarray(expected, np.float64), c.shape)
    if (e <= 0).any():
        raise ValueError("expected counts must be positive")
    return float(((c - e) ** 2 / e).sum())


def mod_bucket_expected(m: int, nb: int, total: int) -> np.ndarray:
    """Exact expected bucket counts for `mod_bucket_counts`: residues r are
    uniform on [0, m); bucket b = (r * nb) >> 32 covers r in
    [ceil(b 2^32 / nb), ceil((b+1) 2^32 / nb)) intersected with [0, m), so
    its expected count is total * width_b / m, in exact integer arithmetic."""
    if m > 1 << 32 or nb > 1 << 32:
        raise ValueError("m and nb must fit 32 bits")
    edges = [min(m, -(-(b << 32) // nb)) for b in range(nb + 1)]
    widths = np.diff(np.asarray(edges, np.float64))
    if (widths <= 0).any():
        raise ValueError(f"nb={nb} too fine for m={m}: empty bucket")
    return total * widths / m


# ---------------------------------------------------------------------------
# Measurements (tensors on their own device)
# ---------------------------------------------------------------------------

def lemire_buckets(h32: torch.Tensor, nb: int) -> torch.Tensor:
    """(...,) u32 hashes (int64) -> int64 bucket ids in [0, nb) via the
    bias-free multiply-shift reduction `(h * nb) >> 32`."""
    return limbs.mulhi32(h32, nb)


def _histogram(idx: torch.Tensor, nb: int) -> torch.Tensor:
    return torch.bincount(idx.reshape(-1), minlength=nb)


def bucket_counts(h32: torch.Tensor, nb: int) -> torch.Tensor:
    """Bucket histogram of 32-bit hashes (Lemire reduction), (nb,) int64."""
    return _histogram(lemire_buckets(h32, nb), nb)


#: Moduli up to this get an exact per-residue histogram; larger moduli use
#: the coarse `(r * nb) >> 32` bucketing, which is only meaningful for m
#: within 2^32/nb of 2^32 (`mod_bucket_expected` rejects anything between).
MAX_EXACT_MOD = 1 << 13


def mod_bucket_counts(acc_hi: torch.Tensor, acc_lo: torch.Tensor, plan,
                      nb: int) -> torch.Tensor:
    """Histogram of the residues `acc mod plan.m` of the 64-bit surfaces
    (acc_hi, acc_lo) -- the same reduction the engine's probe path applies
    (`limbs.mod_u64`). Small moduli (<= MAX_EXACT_MOD) are histogrammed per
    residue (expected = total/m); near-2^32 moduli are coarse-bucketed by
    b = (r * nb) >> 32 with exact expected counts from `mod_bucket_expected`."""
    plan = limbs.as_plan(plan)
    r = limbs.mod_u64((acc_hi << 32) | acc_lo, plan)
    if plan.m <= MAX_EXACT_MOD:
        return _histogram(r, plan.m)
    return _histogram(limbs.mulhi32(r, nb), nb)


def collision_count(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Number of rows with h1 == h2 (0-d int64)."""
    return (h1 == h2).sum()


def joint_counts(h1: torch.Tensor, h2: torch.Tensor, r: int) -> torch.Tensor:
    """(r*r,) int64 joint occupancy of (bucket(h1), bucket(h2)): strong
    universality says the pair is uniform on [0,2^32)^2, so the r x r cells
    are equiprobable -- the 2-D chi^2 is the strong-universality estimator
    (collision tests only see the diagonal)."""
    return _histogram(lemire_buckets(h1, r) * r + lemire_buckets(h2, r), r * r)


def avalanche_bic(fam_fn, toks, khi, klo):
    """Avalanche + bit-independence, one pass per input bit.

    For each of the N*32 input bits: flip it, rehash under the same per-row
    keys, and accumulate (a) per-output-bit flip counts and (b) the max
    |corr| between output-bit flip indicators over the batch.

    Returns (flip_counts (N*32, 32) int64, bic_max 0-d float32), on the
    inputs' device. The correlation is float32 arithmetic, as in the
    reference: the +-1 Gram matrix and the means are exact integers over B.
    """
    base = fam_fn(toks, khi, klo)[0]
    b_rows, n = toks.shape
    counts, bic = [], []
    for i in range(n * 32):
        flipped = toks.clone()
        flipped[:, i // 32] ^= 1 << (i % 32)
        d = fam_fn(flipped, khi, klo)[0] ^ base
        bits = limbs.unpack_bits32(d)                      # (B, 32)
        counts.append(bits.sum(0))
        x = 2.0 * bits.to(torch.float32) - 1.0             # +-1 coding
        c = (x.T @ x) / np.float32(b_rows)                 # E[d_j d_k]
        mu = x.mean(0)
        c = c - mu[:, None] * mu[None, :]                  # covariance
        c = c - torch.diag(torch.diag(c))
        bic.append(c.abs().max())
    return torch.stack(counts), torch.stack(bic).max()


def sac_deviation(flip_counts, b_rows: int) -> float:
    """Max |flip probability - 1/2| over all (input bit, output bit) cells
    -- the strict-avalanche-criterion deviation."""
    p = np.asarray(flip_counts, np.float64) / b_rows
    return float(np.abs(p - 0.5).max())


def sac_bound(n_cells: int, b_rows: int, alpha: float = ALPHA) -> float:
    """PASS threshold for `sac_deviation`: the Sidak-corrected max-cell
    deviation of `n_cells` Binomial(B, 1/2) proportions."""
    return sidak_cell_z(n_cells, alpha) * math.sqrt(0.25 / b_rows)


def bic_bound(n_pairs: int, b_rows: int, alpha: float = ALPHA) -> float:
    """PASS threshold for the max |corr|: Sidak-corrected max of `n_pairs`
    N(0, 1/B) correlations."""
    return sidak_cell_z(n_pairs, alpha) / math.sqrt(b_rows)
