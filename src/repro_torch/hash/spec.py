"""`HashSpec` -- the immutable description of a hash *function family member*.

CLHASH (Lemire & Kaser 2015) and Thorup's integer/string hashing notes both
frame a hash as a keyed object: a *scheme* (which family, how many
independent functions, how many output bits, whether the variable-length
append-1 policy applies) plus *key material*. `HashSpec` is the scheme half;
`Hasher` (hasher.py) binds a spec to concrete key planes.

The spec is a frozen dataclass so it is hashable and can ride in a pytree's
static aux data: two `Hasher`s with equal specs and plans share jit caches.

This is the PyTorch port's own copy of `repro.hash.spec` (pure Python);
`repro_torch.hash.Hasher` binds it to an int64 key tensor on a device.
"""
from __future__ import annotations

import dataclasses

from ..core.keys import derive_stream_seed

# "LEKA" -- Lemire/Kaser. The process-wide default seed of the legacy
# free-function API; keyring reuses it so defaults stay bit-compatible.
DEFAULT_SEED = 0x1E53

@dataclasses.dataclass(frozen=True)
class FamilyTraits:
    """Static traits of a shipped hash family, keyed by name in `FAMILIES`.

    engine:   runs on the fused kernel engine (kernels/multihash.py for the
              integer families, kernels/gf_multihash.py for the carry-less
              ones), i.e. constructible as a `HashSpec`/`Hasher`.
    gf:       carry-less GF(2^32) arithmetic: xor accumulation + Barrett
              polynomial reduction; the engine's 64-bit surface is
              ``h64 = (hash32 << 32) | acc_hi`` (DESIGN.md §11).
    pairwise: HM-style two-characters-per-multiplication pairing (requires
              even padded length).
    acc64:    exposes a full 64-bit accumulator surface to which the
              Barrett `mod_m` probe epilogue (DESIGN.md §2) applies --
              the mod-2^64 accumulator for the integer families, the
              bijective (hash32, acc_hi) packing for the GF ones.
    key_bits: random key width per key word (64 integer / 32 carry-less;
              GF consumes the LO plane of the u64 key streams).
    probe_uniform: fixed-key probe-index uniformity holds per MEMBER (not
              just over the key draw), so the quality battery's
              `probe_path_report` sweeps the family's fused mod-m path.
              True for the non-pairwise families (an odd positional key /
              a full-rank clmul map makes the accumulator uniform over
              random inputs); HM members are only guaranteed over the key
              draw (DESIGN.md §9).
    """

    engine: bool
    gf: bool = False
    pairwise: bool = False
    acc64: bool = True
    key_bits: int = 64
    probe_uniform: bool = False


#: Every shipped family, engine-backed or not. This is the enumeration the
#: quality battery (repro.quality.runner) sweeps; the port keeps the same
#: table so FAMILY_NAMES agrees with the reference.
FAMILIES: "dict[str, FamilyTraits]" = {
    "multilinear": FamilyTraits(engine=True, probe_uniform=True),
    "multilinear_2x2": FamilyTraits(engine=True, pairwise=True),
    "multilinear_hm": FamilyTraits(engine=True, pairwise=True),
    "gf_multilinear": FamilyTraits(engine=True, gf=True, key_bits=32,
                                   probe_uniform=True),
    "gf_multilinear_hm": FamilyTraits(engine=True, gf=True, pairwise=True,
                                      key_bits=32),
    # hash.tree's composed construction (MULTILINEAR leaves + pairwise
    # strongly-universal fold). Not a HashSpec family (the TreeHasher wraps
    # one); registered so the quality battery measures the composition, not
    # just its ingredients.
    "tree_multilinear": FamilyTraits(engine=False),
}

#: Families implemented by the engine (kernels/multihash.py or
#: kernels/gf_multihash.py, + their hostref.py twins) -- the valid
#: `HashSpec.family` values. The carry-less families joined with the GF
#: engine promotion (DESIGN.md §11).
FAMILY_NAMES = tuple(n for n, t in FAMILIES.items() if t.engine)


def registered_families() -> "tuple[str, ...]":
    """All shipped family names (engine + GF), battery-sweep order."""
    return tuple(FAMILIES)


@dataclasses.dataclass(frozen=True)
class HashSpec:
    """Scheme half of a hash function: everything except the random keys.

    family:          one of FAMILY_NAMES (paper §2-§3).
    n_hashes:        K independent functions evaluated per call (k-probe
                     Bloom, fingerprint/split/shard triples, ...).
    out_bits:        32 -> the paper's finished 32-bit hash (uint32);
                     64 -> the family's full 64-bit surface (fingerprints):
                     the mod-2^64 accumulator for the integer families,
                     ``(hash32 << 32) | acc_hi`` for the GF ones (§11).
    variable_length: apply the paper's append-1 rule (prefix-safe hashing
                     of variable-length strings) vs raw fixed-length.
    seed:            int -> stream j uses `derive_stream_seed(seed, j)`;
                     tuple of K ints -> explicit per-stream base seeds
                     (e.g. the pipeline's fp/split/shard salts).
    """

    family: str = "multilinear"
    n_hashes: int = 1
    out_bits: int = 32
    variable_length: bool = True
    seed: "int | tuple[int, ...]" = DEFAULT_SEED

    def __post_init__(self):
        if self.family not in FAMILY_NAMES:
            raise KeyError(f"unknown family {self.family!r}; have {FAMILY_NAMES}")
        if self.n_hashes < 1:
            raise ValueError(f"n_hashes must be >= 1, got {self.n_hashes}")
        if self.out_bits not in (32, 64):
            raise ValueError(f"out_bits must be 32 or 64, got {self.out_bits}")
        if isinstance(self.seed, tuple) and len(self.seed) != self.n_hashes:
            raise ValueError(
                f"explicit seed tuple has {len(self.seed)} entries for "
                f"n_hashes={self.n_hashes}")

    def stream_seeds(self) -> tuple[int, ...]:
        """Per-stream Philox base seeds (stream 0 of an int seed reproduces
        ``KeyBuffer(seed)`` exactly -- the legacy global-key compatibility)."""
        if isinstance(self.seed, tuple):
            return tuple(int(s) for s in self.seed)
        return tuple(derive_stream_seed(self.seed, j)
                     for j in range(self.n_hashes))

    def with_(self, **changes) -> "HashSpec":
        return dataclasses.replace(self, **changes)
