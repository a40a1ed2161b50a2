"""Quality-report battery runner: sweep every registered family through the
statistical battery and emit or verify a QUALITY.json report.

The port of `repro.quality.runner`, on the device it is given (the card
unless ``device="cpu"``). One battery run is a deterministic function of
(seed, sizes): inputs and per-row key material come from counter-based
Threefry streams (keygen.py), histogram counts are exact integers, and
every PASS threshold is a quantile of the exact null distribution
(metrics.py). The streams use the bit layout the committed QUALITY.json was
made with, so `--check` holds a run to its statistics, not only its
verdicts.

Self-validation: the battery carries two seeded known-bad controls
(families.py) and the run FAILS unless both are flagged.

The report is written only to the path `--out` names, never to a default
one; a full-size run with neither `--out` nor a report to check is refused.

Usage:
  python -m repro_torch.quality.runner --out report.json    # full run
  python -m repro_torch.quality.runner --check QUALITY.json # full-size gate
  python -m repro_torch.quality.runner --smoke --device cpu --check-verdicts QUALITY.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import zlib

import numpy as np
import torch

from ..core import limbs
from ..core.device import resolve_device
from ..hash import Hasher, HashSpec
from ..hash import spec as hash_spec
from . import keygen, metrics
from .families import battery_families

SCHEMA = "quality-v1"

#: Adversarial non-power-of-two moduli for the mod-m probe path: tiny odd,
#: the classic 2^12+1, and the largest 32-bit modulus.
MODULI_SMALL = (3, 4097)
MODULUS_HUGE = (1 << 32) - 1

#: Battery string length (32-bit tokens). Even (HM pairing), >= 2 (swap
#: pair), small enough that avalanche's N*32+1 rehashes stay cheap.
N_TOKENS = 4

FULL_KEYS = 1 << 21
FULL_AVALANCHE_KEYS = 1 << 16
SMOKE_KEYS = 1 << 15
SMOKE_AVALANCHE_KEYS = 1 << 12


@dataclasses.dataclass
class MetricResult:
    name: str
    value: float
    threshold: float
    passed: bool
    sigma: "float | None" = None  # equivalent normal z where defined

    def to_dict(self):
        d = {"name": self.name, "value": self.value,
             "threshold": self.threshold, "passed": self.passed}
        if self.sigma is not None:
            d["sigma"] = round(self.sigma, 3)
        return d


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _n_buckets(n_keys: int) -> int:
    """1-D bucket count: capped at 4096, floored so expected counts stay
    >= 64 (Pearson chi^2 deep in its asymptotic regime)."""
    return max(64, min(4096, _pow2_at_most(n_keys // 64)))


def _joint_r(n_keys: int) -> int:
    """Joint-test side length: r*r cells with expected >= 64 per cell."""
    r = 2
    while (2 * r) ** 2 <= n_keys // 64 and 2 * r <= 64:
        r *= 2
    return r


def _chi2_metric(name, counts, expected) -> MetricResult:
    counts = np.asarray(counts)
    df = counts.size - 1
    stat = metrics.chi2_stat(counts, expected)
    return MetricResult(name=name, value=round(stat, 3),
                        threshold=round(metrics.chi2_bound(df), 3),
                        passed=stat <= metrics.chi2_bound(df),
                        sigma=metrics.chi2_sigma(stat, df))


def _family_measurements(fam, n_keys: int, seed: int, device) -> dict:
    """The n_keys measurement pass for one family on `device`: every count
    the chi^2/collision metrics need, as numpy arrays."""
    nb = _n_buckets(n_keys)
    r = _joint_r(n_keys)
    mods = ([limbs.ModPlan.for_modulus(m) for m in (*MODULI_SMALL, MODULUS_HUGE)]
            if fam.acc64 else [])
    key = keygen.battery_key(seed, zlib.crc32(fam.name.encode()))
    toks = keygen.token_batch(key, n_keys, N_TOKENS, device)
    khi, klo = keygen.key_planes(key, n_keys, fam.key_words(N_TOKENS), device)

    def h(t):
        return fam.fn(t, khi, klo)[0]

    hi, lo = fam.fn(toks, khi, klo)
    out = {"uni_random": metrics.bucket_counts(hi, nb)}
    for plan in mods:
        out[f"mod_{plan.m}"] = metrics.mod_bucket_counts(hi, lo, plan, nb)

    # fixed strings (the paper pair doubles as two fixed strings)
    paper_a = torch.zeros(N_TOKENS, dtype=torch.int64, device=toks.device)
    paper_b = paper_a.clone()
    paper_b[0], paper_b[1] = 2, 6
    h_pa = h(paper_a.expand(n_keys, N_TOKENS))
    h_pb = h(paper_b.expand(n_keys, N_TOKENS))
    out["uni_zeros"] = metrics.bucket_counts(h_pa, nb)
    out["uni_paper"] = metrics.bucket_counts(h_pb, nb)

    # pair categories: (h1, h2) under the SAME per-row keys
    pairs = {"paper_2_6": (h_pa, h_pb),
             "random": (hi, h(keygen.pair_partner(key, toks)))}
    low = toks.clone()
    low[:, 0] ^= 1
    pairs["lowbit"] = (hi, h(low))
    high = toks.clone()
    high[:, -1] ^= 1 << 31
    pairs["highbit"] = (hi, h(high))
    # swap: (a, a+1, ...) vs (a+1, a, ...) -- distinct by construction,
    # fixed term-difference; breaks any term-symmetric family
    sw_a = toks.clone()
    sw_a[:, 1] = (toks[:, 0] + 1) & limbs.MASK32
    sw_b = sw_a.clone()
    sw_b[:, 0], sw_b[:, 1] = sw_a[:, 1], sw_a[:, 0]
    pairs["swap01"] = (h(sw_a), h(sw_b))
    for pname, (h1, h2) in pairs.items():
        out[f"coll_{pname}"] = metrics.collision_count(h1, h2)
        out[f"joint_{pname}"] = metrics.joint_counts(h1, h2, r)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_family(fam, n_keys: int, avalanche_keys: int, seed: int, device=None):
    """All metrics for one battery family -> (metrics list, passed)."""
    device = resolve_device(device)
    nb = _n_buckets(n_keys)
    r = _joint_r(n_keys)
    counts = _family_measurements(fam, n_keys, seed, device)

    results = []
    for mname in ("uni_random", "uni_zeros", "uni_paper"):
        results.append(_chi2_metric(mname, counts[mname], n_keys / nb))
    if fam.acc64:
        for m in MODULI_SMALL:
            c = counts[f"mod_{m}"]
            results.append(_chi2_metric(f"mod_{m}", c, n_keys / c.size))
        results.append(_chi2_metric(
            f"mod_{MODULUS_HUGE}", counts[f"mod_{MODULUS_HUGE}"],
            metrics.mod_bucket_expected(MODULUS_HUGE, nb, n_keys)))

    crit = metrics.binom_crit(n_keys, 2.0 ** -32)
    for pname in ("random", "lowbit", "highbit", "swap01", "paper_2_6"):
        c = int(counts[f"coll_{pname}"])
        results.append(MetricResult(
            name=f"coll_{pname}", value=c, threshold=crit - 1,
            passed=c < crit))
        results.append(_chi2_metric(f"joint_{pname}",
                                    counts[f"joint_{pname}"],
                                    n_keys / (r * r)))

    # avalanche + bit independence (fresh keys per row -> exact nulls)
    key = keygen.battery_key(seed, zlib.crc32(fam.name.encode()), 99)
    toks = keygen.token_batch(key, avalanche_keys, N_TOKENS, device)
    khi, klo = keygen.key_planes(key, avalanche_keys,
                                 fam.key_words(N_TOKENS), device)
    flip_counts, bic_max = metrics.avalanche_bic(fam.fn, toks, khi, klo)
    n_bits = N_TOKENS * 32
    sac = metrics.sac_deviation(flip_counts.cpu().numpy(), avalanche_keys)
    results.append(MetricResult(
        name="sac_deviation", value=round(sac, 6),
        threshold=round(metrics.sac_bound(n_bits * 32, avalanche_keys), 6),
        passed=sac <= metrics.sac_bound(n_bits * 32, avalanche_keys)))
    n_pairs = n_bits * (32 * 31) // 2
    bic = float(bic_max)
    results.append(MetricResult(
        name="bic_max_corr", value=round(bic, 6),
        threshold=round(metrics.bic_bound(n_pairs, avalanche_keys), 6),
        passed=bic <= metrics.bic_bound(n_pairs, avalanche_keys)))

    return results, all(m.passed for m in results)


def probe_path_families() -> "list[str]":
    """Registry-driven probe-path sweep set: every engine family whose
    `probe_uniform` trait claims fixed-key probe uniformity."""
    return [name for name in hash_spec.registered_families()
            if hash_spec.FAMILIES[name].engine
            and hash_spec.FAMILIES[name].probe_uniform]


def probe_path_report(n_keys: int, seed: int, device=None) -> dict:
    """Quality coverage of the production probe surface: a fixed-key
    `Hasher.probe_indices` sweep (the engine kernel's fused mod-m epilogue)
    and its `ShardedHasher` twin (`hasher.sharded()`: every visible card,
    or the Hasher's device when it is not a card), at adversarial non-pow2
    moduli, for every `probe_uniform` engine family.

    Fixed-key uniformity is a stronger, per-member property than strong
    universality; the trait marks the families where it holds (MULTILINEAR
    and GF MULTILINEAR). HM members are only guaranteed over the key draw
    (the battery's job)."""
    device = resolve_device(device)
    nb = _n_buckets(n_keys)
    toks = keygen.token_batch(keygen.battery_key(seed, 7), n_keys, N_TOKENS,
                              device).to(torch.int32)
    out = {"families": {}}
    for family in probe_path_families():
        hasher = Hasher.from_spec(
            HashSpec(family=family, n_hashes=2, out_bits=64,
                     variable_length=False, seed=seed),
            max_len=N_TOKENS, device=device)
        sharded = hasher.sharded()
        frep = {"n_hashes": 2, "metrics": [], "sharded_identical": True}
        for m in (*MODULI_SMALL, MODULUS_HUGE):
            plan = limbs.ModPlan.for_modulus(m)
            idx = hasher.probe_indices(toks, plan)
            idx_sh = sharded.probe_indices(toks, plan)
            if not torch.equal(idx, idx_sh):
                frep["sharded_identical"] = False
            for k in range(idx.shape[-1]):
                if m <= metrics.MAX_EXACT_MOD:
                    counts = torch.bincount(idx[:, k], minlength=m)
                    expected = n_keys / m
                else:
                    counts = metrics.bucket_counts(idx[:, k], nb)
                    expected = metrics.mod_bucket_expected(m, nb, n_keys)
                frep["metrics"].append(
                    _chi2_metric(f"probe_mod_{m}/k{k}", counts.cpu().numpy(),
                                 expected).to_dict())
        frep["passed"] = (frep["sharded_identical"]
                          and all(m["passed"] for m in frep["metrics"]))
        out["families"][family] = frep
    out["passed"] = all(f["passed"] for f in out["families"].values())
    return out


def run_battery(n_keys: int = FULL_KEYS,
                avalanche_keys: int = FULL_AVALANCHE_KEYS,
                seed: int = keygen.QUALITY_SEED,
                progress=print, device=None) -> dict:
    """Sweep the full registry + known-bad controls on `device` -> report."""
    device = resolve_device(device)
    report = {"schema": SCHEMA, "seed": seed, "n_keys": n_keys,
              "avalanche_keys": avalanche_keys, "n_tokens": N_TOKENS,
              "families": {}}
    for fam in battery_families():
        res, passed = run_family(fam, n_keys, avalanche_keys, seed, device)
        report["families"][fam.name] = {
            "known_bad": fam.known_bad, "passed": passed,
            "metrics": [m.to_dict() for m in res]}
        worst = max(res, key=lambda m: (not m.passed, m.sigma or 0.0))
        progress(f"# {fam.name}: {'PASS' if passed else 'FAIL'} "
                 f"({len(res)} metrics; worst {worst.name} "
                 f"value={worst.value} vs {worst.threshold})")
    report["probe_path"] = probe_path_report(n_keys, seed, device)
    progress(f"# probe_path: "
             f"{'PASS' if report['probe_path']['passed'] else 'FAIL'}")
    report["self_validated"] = all(
        not f["passed"] for f in report["families"].values()
        if f["known_bad"])
    report["all_shipped_pass"] = all(
        f["passed"] for f in report["families"].values()
        if not f["known_bad"]) and report["probe_path"]["passed"]
    return report


def _iter_verdicts(report, per_metric_bads: bool = True):
    """(key, passed) pairs. With per_metric_bads=False the known-bad
    controls contribute only their family-level verdict: WHICH marginal
    metric flags a control can legitimately depend on the run size, but
    THAT it is flagged never may."""
    for name, f in sorted(report["families"].items()):
        yield f"{name}/__family__", bool(f["passed"])
        if f["known_bad"] and not per_metric_bads:
            continue
        for m in f["metrics"]:
            yield f"{name}/{m['name']}", bool(m["passed"])
    for fname, f in sorted(report["probe_path"]["families"].items()):
        for m in f["metrics"]:
            yield f"probe_path/{fname}/{m['name']}", bool(m["passed"])
        yield f"probe_path/{fname}/sharded_identical", bool(
            f["sharded_identical"])


def _iter_values(report):
    for name, f in sorted(report["families"].items()):
        for m in f["metrics"]:
            yield f"{name}/{m['name']}", float(m["value"])


def compare_reports(committed: dict, fresh: dict, *,
                    verdicts_only: bool, rtol: float = 1e-3) -> "list[str]":
    """Drift between the committed report and a fresh run. Counts are exact
    integers from seeded streams, so statistics agree to float-reduction
    rounding: `rtol` absorbs reduction order, nothing more."""
    problems = []
    a = dict(_iter_verdicts(committed, per_metric_bads=not verdicts_only))
    b = dict(_iter_verdicts(fresh, per_metric_bads=not verdicts_only))
    if set(a) != set(b):
        problems.append(f"metric sets differ: {sorted(set(a) ^ set(b))[:8]}")
    for k in sorted(set(a) & set(b)):
        if a[k] != b[k]:
            problems.append(f"verdict flipped: {k} committed={a[k]} "
                            f"fresh={b[k]}")
    if not verdicts_only:
        va, vb = dict(_iter_values(committed)), dict(_iter_values(fresh))
        for k in sorted(set(va) & set(vb)):
            tol = rtol * max(1.0, abs(va[k]))
            if abs(va[k] - vb[k]) > tol:
                problems.append(f"statistic drifted: {k} "
                                f"committed={va[k]} fresh={vb[k]}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None,
                    help="write the report JSON here (nothing is written "
                         "without it)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"small sizes ({SMOKE_KEYS} keys)")
    ap.add_argument("--check", default=None, metavar="PATH",
                    help="re-run at PATH's sizes and verify verdicts + "
                         "statistics within tolerance")
    ap.add_argument("--check-verdicts", default=None, metavar="PATH",
                    help="verify only the pass/fail pattern against PATH "
                         "(size-independent: use with --smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the host)")
    args = ap.parse_args(argv)

    committed = None
    path = args.check or args.check_verdicts
    if args.check and args.check_verdicts:
        ap.error("--check and --check-verdicts are mutually exclusive")
    if not (args.out or args.smoke or path):
        ap.error("a full run writes its report only to --out; pass --out, "
                 "--check or --smoke")
    if path:
        with open(path) as f:
            committed = json.load(f)
        if committed.get("schema") != SCHEMA:
            print(f"# {path}: unknown schema {committed.get('schema')!r}")
            return 1

    if args.check:
        n_keys = committed["n_keys"]
        avalanche_keys = committed["avalanche_keys"]
        seed = committed["seed"]
    else:
        n_keys = SMOKE_KEYS if args.smoke else FULL_KEYS
        avalanche_keys = (SMOKE_AVALANCHE_KEYS if args.smoke
                          else FULL_AVALANCHE_KEYS)
        seed = keygen.QUALITY_SEED

    report = run_battery(n_keys, avalanche_keys, seed, device=args.device)

    rc = 0
    if not report["self_validated"]:
        print("# FAIL: a seeded known-bad control passed the battery "
              "-- the battery cannot be trusted to gate families")
        rc = 1
    if not report["all_shipped_pass"]:
        print("# FAIL: a shipped family was flagged")
        rc = 1
    if committed is not None:
        problems = compare_reports(committed, report,
                                   verdicts_only=bool(args.check_verdicts))
        for p in problems:
            print(f"# DRIFT: {p}")
        if problems:
            print(f"# FAIL: report drifted from {path} ({len(problems)} "
                  "problem(s))")
            rc = 1
        else:
            print(f"# report reproduces {path} within bounds")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote {args.out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
