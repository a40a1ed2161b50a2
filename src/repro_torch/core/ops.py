"""DEPRECATED free-function hashing API -- thin shims over `repro_torch.hash`.

The port of `repro.core.ops`. The engine lives in `repro_torch.hash`:
`HashSpec` (scheme) + `Hasher` (keys bound to the scheme on a device).
These free functions are bit-identical deprecation aliases; every call
emits one `DeprecationWarning`, attributed to its caller. Nothing inside
the package calls them.

Migration map:
  hash_tokens_host(...)          -> Hasher.from_spec(spec).hash_batch(x, backend="host")
  hash_tokens_device(...)        -> hasher(tokens)
  hash_tokens_device_multi(...)  -> hasher.hash_batch(items)
  fingerprint_bytes(...)         -> repro_torch.hash.fingerprint_bytes(data)
  shard_assignment(...)          -> repro_torch.hash.shard_assignment / Hasher.shard_ids
  global_keys()                  -> repro_torch.hash.keyring.key_buffer()

As elsewhere in the port, the shims that build a `Hasher` take `device=`
(the card unless ``device="cpu"``), and the reference's kernel-route
arguments are gone: Pallas `block_b`, `block_n` and `autotune` (the kernels
take no block shapes) and `hash_tokens_device`'s `use_kernel` (a card
tensor always runs the kernel, a CPU tensor its plain version).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from . import hostref, multilinear
from .keys import KeyBuffer, MultiKeyBuffer

_DEFAULT_SEED = 0x1E53  # "LEKA" -- Lemire/Kaser (== repro_torch.hash.DEFAULT_SEED)


def _warn(name: str, alt: str) -> None:
    warnings.warn(
        f"repro_torch.core.ops.{name} is deprecated; use {alt} from "
        "repro_torch.hash", DeprecationWarning, stacklevel=3)


def global_keys() -> KeyBuffer:
    """Deprecated: the default key buffer is the keyring's deterministic
    default (`repro_torch.hash.keyring.key_buffer()`)."""
    from ..hash import keyring

    _warn("global_keys", "keyring.key_buffer()")
    return keyring.key_buffer(_DEFAULT_SEED)


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    device_fn: Callable          # (tokens, key_hi, key_lo) -> u32 hash
    host_fn: Callable | None     # (tokens, keys_u64) -> u32 hash
    strongly_universal: bool
    needs_even: bool


FAMILIES: dict[str, Family] = {
    "multilinear": Family("multilinear", multilinear.multilinear, hostref.multilinear_np, True, False),
    "multilinear_2x2": Family("multilinear_2x2", multilinear.multilinear_2x2, hostref.multilinear_np, True, True),
    "multilinear_hm": Family("multilinear_hm", multilinear.multilinear_hm, hostref.multilinear_hm_np, True, True),
}


def pad_even(tokens: np.ndarray) -> np.ndarray:
    n = tokens.shape[-1]
    if n % 2 == 0:
        return tokens
    pad = [(0, 0)] * (tokens.ndim - 1) + [(0, 1)]
    return np.pad(tokens, pad)


def _seed_of(keys) -> int:
    return _DEFAULT_SEED if keys is None else int(keys.seed)


def hash_tokens_host(
    tokens: np.ndarray,
    family: str = "multilinear_hm",
    keys: KeyBuffer | None = None,
    variable_length: bool = True,
    *,
    device=None,
) -> np.ndarray:
    """Deprecated shim: hash (..., n) uint32 token arrays on the host.

    Bit-identical to `Hasher.from_spec(spec).hash_batch(x, backend="host")`
    with a single-stream spec (stream 0 is `KeyBuffer(seed)`); `device`
    holds the Hasher's keys.
    """
    from ..hash import HashSpec, keyring

    _warn("hash_tokens_host", "Hasher.hash_batch(..., backend='host')")
    if family not in FAMILIES:
        raise KeyError(family)
    spec = HashSpec(family=family, n_hashes=1, out_bits=32,
                    variable_length=variable_length, seed=_seed_of(keys))
    arr = np.asarray(tokens, dtype=np.uint32)
    n = arr.shape[-1]
    lead = int(np.prod(arr.shape[:-1], dtype=np.int64))  # -1 breaks when n==0
    out = keyring.hasher_for(spec, device=device).hash_batch(
        arr.reshape(lead, n), backend="host")[:, 0]
    return out.reshape(arr.shape[:-1])


def hash_tokens_device(
    tokens,
    family: str = "multilinear_hm",
    keys: KeyBuffer | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Deprecated shim: fixed-length hash of (..., n) token arrays on the
    device, as (...,) int64 u32 values. A tensor hashes on its own device,
    numpy on `device`."""
    from ..hash import HashSpec, keyring

    _warn("hash_tokens_device", "Hasher.__call__")
    if family not in FAMILIES:
        raise KeyError(family)
    spec = HashSpec(family=family, n_hashes=1, out_bits=32,
                    variable_length=False, seed=_seed_of(keys))
    if isinstance(tokens, torch.Tensor):
        device = tokens.device
    n = np.shape(tokens)[-1]
    hasher = keyring.hasher_for(spec, max_len=max(n, 256), device=device)
    return hasher(tokens)[..., 0]


def hash_tokens_device_multi(
    tokens,
    n_hashes: int | None = None,
    *,
    family: str = "multilinear",
    keys: MultiKeyBuffer | None = None,
    seed: int | None = None,
    variable_length: bool = True,
    lengths=None,
    backend: str | None = None,
    out_bits: int = 32,
    device=None,
) -> np.ndarray:
    """Deprecated shim: batched multi-hash (K functions, one fused pass).

    Bit-identical to `Hasher.hash_batch`; this wrapper only maps the legacy
    keyword surface onto a `HashSpec` + key buffer. `backend` is None (the
    Hasher's device) or "host" (the numpy twin).
    """
    from ..hash import Hasher, HashSpec, keyring

    _warn("hash_tokens_device_multi", "Hasher.hash_batch")
    if family not in FAMILIES:
        raise KeyError(family)
    if keys is not None:
        if n_hashes is not None and n_hashes != keys.n_hashes:
            raise ValueError(f"n_hashes={n_hashes} != key buffer's {keys.n_hashes}")
        spec = HashSpec(family=family, n_hashes=keys.n_hashes,
                        out_bits=out_bits, variable_length=variable_length,
                        seed=tuple(keys.seeds))
        hasher = Hasher.from_keys(keys, spec, device=device)
    else:
        spec = HashSpec(family=family, n_hashes=n_hashes or 1,
                        out_bits=out_bits, variable_length=variable_length,
                        seed=_DEFAULT_SEED if seed is None else seed)
        hasher = keyring.hasher_for(spec, device=device)
    return hasher.hash_batch(tokens, lengths=lengths, backend=backend)


def fingerprint_bytes(data: bytes, keys: KeyBuffer | None = None,
                      chunk_words: int = 1 << 16) -> int:
    """Deprecated shim: 64-bit Multilinear fingerprint of a byte string.
    Bit-identical to `repro_torch.hash.fingerprint_bytes` (host numpy)."""
    from ..hash import streaming

    _warn("fingerprint_bytes", "repro_torch.hash.fingerprint_bytes")
    return streaming.fingerprint_bytes(data, seed=_seed_of(keys), keys=keys,
                                       chunk_words=chunk_words)


def shard_assignment(tokens: np.ndarray, n_shards: int, salt: int = 0,
                     backend: str | None = None, *, device=None) -> np.ndarray:
    """Deprecated shim: deterministic shard id per row of (..., n) tokens,
    Lemire's multiply-shift `(h * n_shards) >> 32` of the 32-bit hash."""
    from ..hash import sharding

    _warn("shard_assignment", "repro_torch.hash.shard_assignment / Hasher.shard_ids")
    return sharding.shard_assignment(tokens, n_shards, salt=salt,
                                     backend=backend, device=device)
