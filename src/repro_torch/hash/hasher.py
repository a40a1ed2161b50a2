"""`Hasher` -- K strongly universal hash functions bound to device keys.

The PyTorch port of `repro.hash.hasher.Hasher`. A `Hasher` binds a
`HashSpec` (scheme) to one (K, cap+1) int64 tensor of u64 key bits on a
device (m1 at column 0, positional keys after it). Two call surfaces:

- ``hasher(tokens, lengths=None)`` -- tensors in, tensors out, no host
  syncs: one fused kernel launch for all K functions.
- ``hasher.hash_batch(items, ...)`` -- numpy or ragged lists in, numpy out
  (uint32 / uint64 exactly as the reference returns them), one launch per
  batch; ``backend="host"`` runs the numpy twin instead.
- ``hasher.stream()/.update()/.digest()`` -- incremental two-level
  fingerprints of long token streams (streaming.py).
- ``hasher.sharded(mesh)`` -- the same hashes with the rows split over a
  mesh's shards (distributed.py).

Tokens enter as int32 tensors holding u32 bits (uint32 tensors and numpy
arrays are converted). Hash values leave as int64 tensors holding u32
values. Entry points run on ``cuda`` unless the caller passes ``device=``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..core import hostref, limbs
from ..core.device import as_tokens, resolve_device
from ..core.keys import MultiKeyBuffer, planes_to_keys
from ..kernels import ops as kops
from ..kernels.autotune import pow2_at_least
from . import streaming
from .spec import FAMILIES, HashSpec


def _even(n: int) -> int:
    return n + (n & 1)


def _stack_ragged(tokens):
    """Tokens as a (B, N) uint32 array + per-row lengths (None if the input
    was already a dense 2-D batch)."""
    if isinstance(tokens, (list, tuple)):
        rows = [np.atleast_1d(np.asarray(r)) for r in tokens]
        lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
        out = np.zeros((len(rows), int(lens.max(initial=0))), np.uint32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out, lens
    arr = np.atleast_2d(np.asarray(tokens)).astype(np.uint32)
    return arr, None


class Hasher:
    """K strongly universal hash functions with their keys on one device.

    Build with `Hasher.from_spec(spec)` (keys from the spec's seeds),
    `Hasher.from_keys(mkb, spec)` (an existing key buffer) or
    `Hasher.from_numpy_planes(key_hi, key_lo, spec)` (the reference
    `Hasher`'s planes). Growth returns a new Hasher (`ensure`); the Philox
    streams guarantee the wider planes extend the old ones bit-exactly.
    """

    def __init__(self, keys: torch.Tensor, spec: HashSpec,
                 _mkb: MultiKeyBuffer | None = None):
        if keys.dtype != torch.int64 or keys.shape[0] != spec.n_hashes:
            raise ValueError(f"keys must be ({spec.n_hashes}, cap+1) int64")
        self.keys = keys
        self.spec = spec
        self._mkb = _mkb
        self._batch_keys = keys  # widest planes staged for hash_batch

    @property
    def device(self) -> torch.device:
        return self.keys.device

    # -- construction --------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: HashSpec = HashSpec(), *, max_len: int = 256,
                  device=None) -> "Hasher":
        mkb = MultiKeyBuffer(seeds=list(spec.stream_seeds()))
        return cls.from_keys(mkb, spec, max_len=max_len, device=device)

    @classmethod
    def from_keys(cls, mkb: MultiKeyBuffer, spec: HashSpec, *,
                  max_len: int = 256, device=None) -> "Hasher":
        if mkb.n_hashes != spec.n_hashes:
            raise ValueError(
                f"key buffer has {mkb.n_hashes} streams, spec wants "
                f"{spec.n_hashes}")
        device = resolve_device(device)
        cap = pow2_at_least(max(2, _even(max_len + 2)))
        return cls(cls._upload(mkb, cap, device), spec, _mkb=mkb)

    @classmethod
    def from_numpy_planes(cls, key_hi, key_lo, spec: HashSpec, *,
                          device=None) -> "Hasher":
        """Bind the reference Hasher's (K, cap+1) uint32 planes (its
        `key_hi`/`key_lo` as numpy arrays). The result cannot grow."""
        device = resolve_device(device)
        keys = torch.from_numpy(planes_to_keys(key_hi, key_lo)).to(device)
        return cls(keys, spec)

    @staticmethod
    def _upload(mkb: MultiKeyBuffer, width: int, device) -> torch.Tensor:
        u64 = mkb.stacked_u64(width + 1)  # read-only memo: copy, never alias
        return torch.from_numpy(u64.view(np.int64).copy()).to(device)

    @property
    def capacity(self) -> int:
        """Positional keys on the device (the widest hashable row + 1)."""
        return int(self.keys.shape[1]) - 1

    def ensure(self, max_len: int) -> "Hasher":
        """A Hasher whose keys cover rows up to `max_len` tokens."""
        if self.capacity >= _even(max_len + 2):
            return self
        if self._mkb is None:
            raise ValueError("cannot grow a Hasher detached from its key "
                             "buffer (rebuild via Hasher.from_spec)")
        return Hasher.from_keys(self._mkb, self.spec, max_len=max_len,
                                device=self.device)

    # -- tensor call path ----------------------------------------------------

    def _required_width(self, n: int) -> int:
        return max(2, _even(n + 1) if self.spec.variable_length else _even(n))

    def __call__(self, tokens, lengths=None) -> torch.Tensor:
        """(..., N) tokens -> (..., K) int64 32-bit hashes (out_bits=32), or
        (..., K, 2) int64 (hi, lo) halves of the family's 64-bit surface
        (out_bits=64; hi is the 32-bit hash). `lengths` (variable-length
        specs only) gives per-row token counts; the default is full rows."""
        out = self._hash_slots(tokens, lengths)
        return out[..., 0] if self.spec.out_bits == 32 else out

    def _hash_slots(self, tokens, lengths=None, mod_m=None) -> torch.Tensor:
        """(..., N) tokens -> (..., K, 2) slots in one fused launch. Every
        tensor call (`__call__`, `probe_indices`, `shard_ids`, `bit_planes`)
        comes through here: while tracing is on it is the call's root span,
        `hasher.hash_slots` (`hash_batch` starts at the launch layer's
        `launch.multihash` instead)."""
        sp = tracing.begin("hasher.hash_slots") if tracing.ON else None
        try:
            spec = self.spec
            toks = as_tokens(tokens, self.device)
            batch_shape = toks.shape[:-1]
            N = toks.shape[-1]
            toks2 = toks.reshape(-1, N).contiguous()
            B = toks2.shape[0]
            W = self._required_width(N)
            if self.capacity < W:
                raise ValueError(
                    f"Hasher capacity {self.capacity} < required width {W} for "
                    f"rows of {N} tokens; use hasher.ensure({N})")
            if lengths is None:
                code = torch.full((B,), N if spec.variable_length else -(N + 1),
                                  dtype=torch.int32, device=self.device)
            else:
                if not spec.variable_length:
                    raise ValueError("lengths only apply with variable_length=True")
                code = torch.as_tensor(lengths, device=self.device).reshape(-1).to(
                    torch.int32)
            out = kops.multihash(toks2, self.keys, code, family=spec.family,
                                 mod_m=mod_m, width=W,
                                 ragged=lengths is not None)
            return out.reshape(*batch_shape, spec.n_hashes, 2)
        finally:
            if sp is not None:
                tracing.end(sp)

    @property
    def _is_gf(self) -> bool:
        return FAMILIES[self.spec.family].gf

    def bit_planes(self, tokens, lengths=None) -> torch.Tensor:
        """(..., N) tokens -> (..., K, 32) int64 bit planes of the 32-bit
        hash(es), LSB first: plane [..., k, j] = bit j of hash k."""
        return limbs.unpack_bits32(self._hash_slots(tokens, lengths)[..., 0])

    def shard_ids(self, tokens, n_shards: int, lengths=None) -> torch.Tensor:
        """(..., N) tokens -> (...,) int32 shard ids in [0, n_shards): Lemire's
        multiply-shift ``(h * n_shards) >> 32`` on the first 32-bit hash."""
        h = self._hash_slots(tokens, lengths)[..., 0, 0]
        return limbs.mulhi32(h, int(n_shards)).to(torch.int32)

    def probe_indices(self, tokens, plan, lengths=None) -> torch.Tensor:
        """(..., N) tokens -> (..., K) int64 Bloom probe indices in [0, m):
        the family's 64-bit surface mod m, reduced inside the kernel.

        plan: a `limbs.ModPlan` or an int modulus. Needs an out_bits=64
        spec: probe identity is defined on the full surface."""
        if self.spec.out_bits != 64:
            raise ValueError("probe_indices needs out_bits=64 (the mod-m "
                             "reduction consumes the full accumulator)")
        return self._hash_slots(tokens, lengths,
                                mod_m=limbs.as_plan(plan))[..., 0]

    # -- host-convenience batched engine -------------------------------------

    def _keys_for_width(self, width: int) -> torch.Tensor:
        """Device keys covering `width` positional columns (grown from the
        key buffer and kept for later batches when the planes are short)."""
        if self._batch_keys.shape[1] - 1 < width:
            if self._mkb is None:
                raise ValueError("hash_batch needs the Hasher's key buffer "
                                 "for rows wider than its capacity")
            self._batch_keys = self._upload(self._mkb, pow2_at_least(width),
                                            self.device)
        return self._batch_keys

    def hash_batch(self, tokens, *, lengths=None,
                   variable_length: bool | None = None,
                   out_bits: int | None = None,
                   backend: str | None = None) -> np.ndarray:
        """K hashes of every row of a dense (B, N) or ragged batch, in one
        fused launch. Returns (B, K) uint32 (out_bits=32) or uint64
        (out_bits=64), exactly as the reference does.

        backend: None runs on the Hasher's device; 'host' runs the
        vectorized numpy twin (bit-identical, no launch).
        """
        if backend not in (None, "host"):
            raise ValueError(f"unknown backend {backend!r} (None or 'host')")
        spec = self.spec
        variable_length = (spec.variable_length if variable_length is None
                           else variable_length)
        out_bits = spec.out_bits if out_bits is None else out_bits
        toks, ragged_lens = _stack_ragged(tokens)
        if lengths is None:
            if ragged_lens is not None and not variable_length:
                raise ValueError(
                    "ragged input requires variable_length=True (fixed-length "
                    "semantics are ambiguous for rows of different lengths); "
                    "pass a dense (B, N) array for fixed-length hashing")
            lengths = ragged_lens
        B, N = toks.shape
        # room for the sentinel + the HM even pad
        n_req = _even(N + 2) if variable_length else _even(N)
        lens = hostref.encode_lengths(lengths, N, variable_length, B)

        if backend == "host":
            acc = self._hash_host(toks, lens, n_req)
        else:
            out = kops.multihash(
                as_tokens(toks, self.device), self._keys_for_width(n_req),
                torch.from_numpy(lens).to(self.device), family=spec.family,
                width=n_req, ragged=lengths is not None).cpu().numpy().astype(
                    np.uint64)
            acc = (out[:, :, 0] << np.uint64(32)) | out[:, :, 1]
        if out_bits == 64:
            return acc
        return (acc >> np.uint64(32)).astype(np.uint32)

    def _hash_host(self, toks, lens, n_req) -> np.ndarray:
        """(B, K) uint64 surfaces from the numpy twin (pow2-bucketed width,
        as the reference's host path, so the key memo stays bounded)."""
        n_h = pow2_at_least(n_req)
        toks_h = np.zeros((toks.shape[0], n_h), np.uint32)
        toks_h[:, :toks.shape[1]] = toks
        if self._mkb is not None:
            keys = self._mkb.stacked_u64(n_h + 1)
        else:
            keys = self._keys_for_width(n_h)[:, :n_h + 1].cpu().numpy().view(
                np.uint64)
        if self._is_gf:
            return hostref.gf_multilinear_multi_np(
                toks_h, lens, (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                family=self.spec.family)
        return hostref.multilinear_multi_np(toks_h, lens, keys,
                                            family=self.spec.family)

    # -- streaming (two-level UMAC-style tree; see streaming.py) --------------

    def stream(self, chunk_words: int = 1024, max_chunks: int = 4096):
        """Fresh incremental-fingerprint state (see `streaming.StreamState`)."""
        return streaming.init_stream(self, chunk_words, max_chunks)

    def update(self, state, tokens):
        """Absorb a 1-D token block into the stream (one kernel launch on
        the card when the block completes chunks)."""
        return streaming.update(self, state, tokens)

    def digest(self, state):
        """Finalize: (2,) int64 (hi, lo) u32 halves of the 64-bit fingerprint."""
        return streaming.digest(self, state)

    def digest_int(self, state) -> int:
        """`digest` as a Python int (one device sync)."""
        streaming._check_overflow(state)
        hi, lo = self.digest(state).tolist()
        return (hi << 32) | lo

    # -- scale-out ------------------------------------------------------------

    def sharded(self, mesh=None, axis: str = "data"):
        """Scale this Hasher out over a mesh data axis: a `ShardedHasher`
        (hash.distributed) partitioning every batch over `axis`, with
        results equal to this Hasher's. `mesh=None` is every visible card
        (or this Hasher's device when it is not a card)."""
        from .distributed import ShardedHasher

        return ShardedHasher(self, mesh, axis)

    def __repr__(self):
        return (f"Hasher({self.spec}, device={self.device}, "
                f"capacity={self.capacity})")
