"""Deterministic default key material behind a small bounded LRU.

The port of `repro.hash.keyring`: pure functions of the spec (and device),
cached so hot callers (per-salt shard routing) neither regenerate Philox
streams nor re-upload key planes on every call. Evicting an entry can
change cost, never values.
"""
from __future__ import annotations

from collections import OrderedDict

from ..core.device import resolve_device
from ..core.keys import KeyBuffer, MultiKeyBuffer
from .hasher import Hasher
from .spec import DEFAULT_SEED, HashSpec

_BUFFERS: "OrderedDict[tuple, MultiKeyBuffer]" = OrderedDict()
_HASHERS: "OrderedDict[tuple, Hasher]" = OrderedDict()
_MAX_ENTRIES = 32


def _lru_put(cache: OrderedDict, key, val):
    cache[key] = val
    cache.move_to_end(key)
    while len(cache) > _MAX_ENTRIES:
        cache.popitem(last=False)  # least-recently-used goes first
    return val


def clear():
    """Drop all cached default key material (tests; values never change)."""
    _BUFFERS.clear()
    _HASHERS.clear()


def buffer_for(spec: HashSpec) -> MultiKeyBuffer:
    """The spec's deterministic K-stream key buffer (LRU-shared)."""
    seeds = spec.stream_seeds()
    hit = _BUFFERS.get(seeds)
    if hit is not None:
        _BUFFERS.move_to_end(seeds)
        return hit
    return _lru_put(_BUFFERS, seeds, MultiKeyBuffer(seeds=list(seeds)))


def key_buffer(seed: int = DEFAULT_SEED) -> KeyBuffer:
    """Single-stream `KeyBuffer(seed)` equivalent (stream 0 of the spec's
    buffer)."""
    return buffer_for(HashSpec(seed=seed)).buffers[0]


def hasher_for(spec: HashSpec, *, max_len: int = 256, device=None) -> Hasher:
    """LRU-cached `Hasher` for a spec on a device. Asking for a longer
    `max_len` replaces the entry with a wider Hasher over the same streams."""
    device = resolve_device(device)
    key = (spec, str(device))
    h = _HASHERS.get(key)
    if h is None or h.capacity < max(2, max_len + 2):
        h = Hasher.from_keys(buffer_for(spec), spec, max_len=max_len,
                             device=device)
    return _lru_put(_HASHERS, key, h)
