"""Incremental fingerprints: the two-level UMAC-style Multilinear tree over
token streams (`Hasher.stream()/.update()/.digest()`), and the host byte
fingerprint `fingerprint_bytes`.

The port of `repro.hash.streaming`. Construction (strongly universal at each
level, paper §3 + UMAC's tree trick): the stream is split into fixed
`chunk_words` chunks; each complete chunk gets a 64-bit level-1 MULTILINEAR
fingerprint (stream 0 of the Hasher's keys); the sequence of chunk
fingerprints -- as (lo, hi) 32-bit word pairs -- is itself
MULTILINEAR-hashed by an independent level-2 key stream, accumulated
incrementally (each finished chunk folds in as k_{2g+1} lo_g + k_{2g+2}
hi_g). `digest` absorbs the final partial chunk plus a (total_words,
n_chunks) length pair. Values are bit-identical to the reference.

On a CUDA Hasher the level-1 fingerprints of the chunks an update completes
come from one launch of the single-hash kernel (`kernels.multilinear`, the
raw accumulator of each (R, chunk_words) row, plus m1); on the CPU from its
plain version. Unlike the reference's jit pytree, `StreamState` keeps its
cursors `fill` and `count` as Python ints: block lengths are known on the
host, so no update waits for the device to learn how many chunks it
finished.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import hostref
from ..core.device import as_tokens
from ..core.keys import KeyBuffer
from ..core.limbs import MASK32, hi32, lo32
from ..kernels import multilinear as mlk
from .spec import DEFAULT_SEED

# Domain-separation tag for the level-2 key stream: independent of every
# level-1 stream (which use derive_stream_seed(seed, j) = seed ^ j*GOLDEN64).
_L2_TAG = 0x5ECD_1EE7_F1F0_57A9


def level2_seed(stream0_seed: int) -> int:
    return (int(stream0_seed) ^ _L2_TAG) % (1 << 64)


@dataclasses.dataclass(frozen=True)
class StreamState:
    """State of one incremental fingerprint (updates return a new state).

    buf/fill:    the current partial chunk, (chunk_words,) int32 on the
                 Hasher's device (zeros beyond `fill`).
    acc:         running level-2 sum over finished chunk fingerprints, a 0-d
                 int64 tensor of u64 bits.
    count:       chunks finished so far (level-2 key cursor).
    l2:          (2 max_chunks + 3,) int64 level-2 keys (index 0 = level-2 m1).
    """

    buf: torch.Tensor
    fill: int
    acc: torch.Tensor
    count: int
    l2: torch.Tensor
    chunk_words: int
    max_chunks: int


def _l2_keys(hasher, max_chunks: int) -> np.ndarray:
    return KeyBuffer(seed=level2_seed(hasher.spec.stream_seeds()[0]),
                     initial=2 * max_chunks + 4).u64(2 * max_chunks + 3)


def init_stream(hasher, chunk_words: int, max_chunks: int) -> StreamState:
    if chunk_words < 1:
        raise ValueError("chunk_words must be >= 1")
    if hasher.capacity < chunk_words:
        raise ValueError(
            f"Hasher capacity {hasher.capacity} < chunk_words {chunk_words}; "
            f"build via Hasher.from_spec(spec, max_len={chunk_words})")
    dev = hasher.device
    l2 = torch.from_numpy(_l2_keys(hasher, max_chunks).view(np.int64)).to(dev)
    return StreamState(
        buf=torch.zeros(chunk_words, dtype=torch.int32, device=dev), fill=0,
        acc=torch.zeros((), dtype=torch.int64, device=dev), count=0, l2=l2,
        chunk_words=int(chunk_words), max_chunks=int(max_chunks))


def _check_overflow(state: StreamState, extra_tokens: int = 0) -> None:
    """Fail loudly when a stream would exceed its max_chunks bound (past it
    the level-2 keys run out and chunks would fold with wrong keys)."""
    words = state.fill + extra_tokens
    # a trailing partial chunk consumes one more level-2 slot at digest time
    chunks = (state.count + words // state.chunk_words
              + bool(words % state.chunk_words))
    if chunks > state.max_chunks:
        raise ValueError(
            f"stream overflow: {chunks} chunks exceeds the static "
            f"max_chunks={state.max_chunks} bound (rebuild the stream with "
            f"a larger max_chunks or chunk_words)")


def _level1_fp(hasher, rows: torch.Tensor) -> torch.Tensor:
    """(R, chunk_words) int32 rows -> (R,) int64 u64 chunk fingerprints
    m1 + sum k_i w_i (stream 0 keys; zeros beyond a row's fill add 0)."""
    keys = hasher.keys[0, 1:rows.shape[1] + 1]
    acc = mlk.hash_blocks(rows, keys, family="multilinear")
    return ((acc[:, 0] << 32) | acc[:, 1]) + hasher.keys[0, 0]


def _l2_sum(state: StreamState, g: int, w_lo, w_hi) -> torch.Tensor:
    """sum_j k_{2(g+j)+1} w_lo[j] + k_{2(g+j)+2} w_hi[j] mod 2^64."""
    n = w_lo.shape[0]
    ka = state.l2[2 * g + 1:2 * (g + n) + 1:2]
    kb = state.l2[2 * g + 2:2 * (g + n) + 2:2]
    return (ka * w_lo + kb * w_hi).sum()


def update(hasher, state: StreamState, tokens) -> StreamState:
    """Absorb a token block (flattened; values taken as u32): buffer the
    partial chunk, fingerprint every chunk the block completes in one
    kernel launch, and fold each into the level-2 sum at its position."""
    toks = as_tokens(tokens, hasher.device).reshape(-1)
    n, cw = toks.shape[0], state.chunk_words
    if n == 0:
        return state
    _check_overflow(state, extra_tokens=n)
    total = state.fill + n
    c = total // cw  # chunks this block completes
    acc = state.acc
    if c:
        ext = torch.cat([state.buf[:state.fill], toks])
        fp = _level1_fp(hasher, ext[:c * cw].view(c, cw))
        acc = acc + _l2_sum(state, state.count, lo32(fp), hi32(fp))
        tail = ext[c * cw:]
    else:
        tail = torch.cat([state.buf[:state.fill], toks])
    buf = torch.zeros_like(state.buf)
    buf[:tail.shape[0]] = tail
    return dataclasses.replace(state, buf=buf, fill=total - c * cw, acc=acc,
                               count=state.count + c)


def digest(hasher, state: StreamState) -> torch.Tensor:
    """Finalize to the (2,) int64 (hi, lo) u32 halves of the 64-bit
    fingerprint: absorb the partial chunk (if any), then a (total_words
    mod 2^32, n_chunks) length pair as the last level-2 contribution."""
    acc, g = state.acc, state.count
    if state.fill:
        fp = _level1_fp(hasher, state.buf[None, :])
        acc = acc + _l2_sum(state, g, lo32(fp), hi32(fp))
        g += 1
    tot = (state.count * state.chunk_words + state.fill) & MASK32
    acc = acc + state.l2[2 * g + 1] * tot + state.l2[2 * g + 2] * g + state.l2[0]
    return torch.stack([hi32(acc), lo32(acc)])


def stream_digest_host(hasher, tokens, chunk_words: int,
                       max_chunks: int = 4096) -> int:
    """Numpy uint64 reference of stream()/update()/digest() over the whole
    token sequence at once (the ground truth for the incremental path)."""
    if chunk_words < 1:
        raise ValueError("chunk_words must be >= 1")
    toks = np.asarray(tokens, np.uint32).reshape(-1)
    n = len(toks)
    needed = n // chunk_words + bool(n % chunk_words)
    if needed > max_chunks:
        raise ValueError(
            f"stream overflow: {needed} chunks exceeds the static "
            f"max_chunks={max_chunks} bound (rebuild the stream with "
            f"a larger max_chunks or chunk_words)")
    if hasher._mkb is not None:
        k1 = hasher._mkb.buffers[0].u64(chunk_words + 1)
    else:  # bound to numpy planes: stream 0's keys are row 0
        k1 = hasher.keys[0, :chunk_words + 1].cpu().numpy().view(np.uint64)
    l2 = _l2_keys(hasher, max_chunks)
    with np.errstate(over="ignore"):
        count, fill = n // chunk_words, n % chunk_words
        acc = np.uint64(0)
        for j in range(count + (1 if fill else 0)):
            chunk = np.zeros(chunk_words, np.uint32)
            part = toks[j * chunk_words : (j + 1) * chunk_words]
            chunk[: len(part)] = part
            fp = hostref.multilinear_np_u64(chunk, k1)
            acc += l2[2 * j + 1] * np.uint64(fp & np.uint64(0xFFFFFFFF))
            acc += l2[2 * j + 2] * np.uint64(fp >> np.uint64(32))
        ce = count + (1 if fill else 0)
        tot = np.uint64((count * chunk_words + fill) & 0xFFFFFFFF)
        acc += l2[2 * ce + 1] * tot + l2[2 * ce + 2] * np.uint64(ce)
        return int(acc + l2[0])


def fingerprint_bytes(data: bytes, *, seed: int = DEFAULT_SEED, keys=None,
                      chunk_words: int = 1 << 16, tree=None) -> int:
    """64-bit Multilinear fingerprint of a byte string (checkpoint integrity).

    Bytes are padded to a whole number of 32-bit words, length-prepended
    (paper's variable-length extension), and folded chunkwise: chunk
    fingerprints are themselves a string of 64-bit values hashed again
    (two-level tree, as UMAC does). Host numpy, as in the reference.

    `tree` (a `hash.tree.TreeHasher`) routes EVERY call through the tree
    fingerprint instead -- different values than the default serial layout
    (a digest scheme, not a knob), computed on the TreeHasher's device.
    """
    if chunk_words < 1:
        raise ValueError("chunk_words must be >= 1")
    if tree is not None:
        return tree.fingerprint_bytes(data)
    from . import keyring

    kb = keys if keys is not None else keyring.key_buffer(seed)
    n_bytes = len(data)
    pad = (-n_bytes) % 4
    arr = np.frombuffer(data + b"\0" * pad, dtype="<u4")
    arr = np.concatenate(
        [np.asarray([n_bytes & 0xFFFFFFFF, n_bytes >> 32], np.uint32), arr])
    ku = kb.u64(chunk_words + 1)
    fps = []
    for i in range(0, len(arr), chunk_words):
        chunk = arr[i : i + chunk_words]
        fps.append(hostref.multilinear_np_u64(chunk.astype(np.uint32), ku))
    if len(fps) == 1:
        return int(fps[0])
    # level 2: hash the vector of 64-bit fingerprints as 32-bit halves
    flat = np.asarray(fps, dtype=np.uint64)
    words = np.empty(2 * len(flat), np.uint32)
    words[0::2] = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words[1::2] = (flat >> np.uint64(32)).astype(np.uint32)
    return int(hostref.multilinear_np_u64(words, kb.u64(len(words) + 1)))
