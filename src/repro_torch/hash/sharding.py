"""Content-addressed shard routing on the Hasher engine.

The port of `repro.hash.sharding`: range reduction is Lemire's
multiply-shift ``(h * n_shards) >> 32`` on the 32-bit hash (no modulo
bias, one multiply). `Hasher.shard_ids` is the tensor-path equivalent.
"""
from __future__ import annotations

import numpy as np

from ..core.keys import _GOLDEN64
from . import keyring
from .spec import DEFAULT_SEED, HashSpec


def salt_spec(salt: int = 0, n_hashes: int = 1) -> HashSpec:
    """The routing spec for a salt (the reference's seed derivation)."""
    seed = DEFAULT_SEED ^ (salt * _GOLDEN64 % (1 << 63))
    return HashSpec(family="multilinear_hm", n_hashes=n_hashes,
                    variable_length=True, seed=seed)


def reduce_range(h: np.ndarray, n_shards: int) -> np.ndarray:
    """Lemire multiply-shift: uniform map of uint32 hashes onto [0, n)."""
    return ((h.astype(np.uint64) * np.uint64(n_shards)) >> np.uint64(32)
            ).astype(np.int32)


def shard_assignment(tokens, n_shards: int, salt: int = 0,
                     backend: str | None = None, device=None) -> np.ndarray:
    """Deterministic shard id per row of (..., n) tokens, one launch per
    batch (host convenience; `Hasher.shard_ids` is the tensor path)."""
    arr = np.atleast_2d(np.asarray(tokens, np.uint32))
    batch_shape = arr.shape[:-1]
    hasher = keyring.hasher_for(salt_spec(salt), device=device)
    h = hasher.hash_batch(arr.reshape(-1, arr.shape[-1]),
                          out_bits=32, backend=backend)[:, 0]
    out = reduce_range(h, n_shards).reshape(batch_shape)
    return out if np.asarray(tokens).ndim > 1 else out[0]
