"""Dedup structures built on the paper's fingerprints: exact set + Bloom.

The port of `repro.data.dedup`. The Bloom filter's k probe functions are k
independent hashes of one `Hasher` (any engine family); batch admission
hashes the whole batch in ONE fused kernel launch, single-item calls use
the bit-identical numpy host path. The bit array and the exact seen-set
stay on the host, as in the reference (`load_bits` takes the reference
filter's words as they are).
"""
from __future__ import annotations

import math

import numpy as np

from ..hash import Hasher, HashSpec
from ..parallel.sharding import home_device


class BloomFilter:
    """k-probe Bloom filter over variable-length token strings.

    Probe indices are the family's full 64-bit surfaces mod m, so modulo
    bias is ~m/2^64 even when m approaches 2^32.
    """

    def __init__(self, n_items: int, fp_rate: float = 1e-3, seed: int = 0xB100,
                 family: str = "multilinear", device=None):
        self.m = max(64, int(-n_items * math.log(fp_rate) / (math.log(2) ** 2)))
        self.k = max(1, int(self.m / n_items * math.log(2)))
        self.bits = np.zeros((self.m + 63) // 64, np.uint64)
        self.hasher = Hasher.from_spec(HashSpec(
            family=family, n_hashes=self.k, out_bits=64,
            variable_length=True, seed=seed), device=device)

    def load_bits(self, bits: np.ndarray) -> None:
        """Replace the bit array with another filter's words (same m)."""
        bits = np.asarray(bits)
        if bits.dtype != np.uint64 or bits.shape != self.bits.shape:
            raise ValueError(f"bits must be {self.bits.shape} uint64, got "
                             f"{bits.shape} {bits.dtype}")
        self.bits = bits.copy()

    def _hashes(self, items, backend=None) -> np.ndarray:
        """(B, k) uint64 surfaces -- ONE fused launch for the whole batch."""
        return self.hasher.hash_batch(items, backend=backend)

    def _probes(self, items) -> np.ndarray:
        return (self._hashes(items) % np.uint64(self.m)).astype(np.int64)

    def _indices(self, item) -> np.ndarray:
        """(k,) probe indices for one item (numpy host path)."""
        h = self._hashes([np.atleast_1d(item)], backend="host")[0]
        return (h % np.uint64(self.m)).astype(np.int64)

    def _set(self, idx: np.ndarray) -> None:
        np.bitwise_or.at(self.bits, idx // 64,
                         np.uint64(1) << (idx.astype(np.uint64) % np.uint64(64)))

    def _test(self, idx: np.ndarray) -> np.ndarray:
        word = self.bits[idx // 64] >> (idx.astype(np.uint64) % np.uint64(64))
        return (word & np.uint64(1)).astype(bool)

    def add(self, item) -> None:
        self._set(self._indices(item))

    def __contains__(self, item) -> bool:
        return bool(self._test(self._indices(item)).all())

    def add_batch(self, items) -> None:
        """Admit a batch of items with a single k-probe hash launch."""
        if len(items) == 0:
            return
        self._set(self._probes(items).ravel())

    def contains_batch(self, items) -> np.ndarray:
        """(B,) bool membership for a batch -- one launch."""
        if len(items) == 0:
            return np.zeros(0, bool)
        idx = self._probes(items)
        return self._test(idx.ravel()).reshape(idx.shape).all(axis=1)

    def check_and_add_batch(self, items) -> np.ndarray:
        """(B,) bool admission mask (True = newly admitted), exact in
        arrival order: item i is tested against the pre-batch bits plus the
        bits set by the items admitted before it, so an in-batch duplicate
        rejects. One fused hash launch; the sequential test/set touches only
        the host bit words."""
        if len(items) == 0:
            return np.zeros(0, bool)
        idx = self._probes(items)
        out = np.zeros(len(idx), bool)
        for i, row in enumerate(idx):
            if not self._test(row).all():
                self._set(row)
                out[i] = True
        return out


class ExactDedup:
    """64-bit fingerprint set. Collision probability for N docs is
    ~N^2 / 2^65 (strong universality): negligible below ~10^8 docs.

    With `mesh`, batched fingerprinting scales out over the mesh data axis
    (`hash.distributed.ShardedHasher`: B/D rows hashed a shard, the same
    values), and long documents' tree leaves shard too. The seen-set stays
    on the host -- it is the sequential arrival-order authority.

    With `approx_items=N` the host set is replaced by a
    `DeviceShardedBloom` admission authority over `mesh` (FP rate 1e-3,
    probes moved under `probe_transport`, default "routed"): dedup for
    corpora whose exact fingerprint set won't fit host memory. Verdicts
    then carry Bloom semantics: a ~1e-3 false-duplicate rate, and
    in-batch duplicates ALL admit (pre-batch-state contract) instead of
    first-occurrence-wins. `device` defaults to the mesh's first device,
    else the card.
    """

    def __init__(self, seed: int = 0xDED0, device=None, mesh=None,
                 approx_items: int | None = None, probe_transport="routed"):
        device = home_device(mesh, device)
        self.hasher = Hasher.from_spec(HashSpec(
            family="multilinear", n_hashes=1, out_bits=64,
            variable_length=True, seed=seed), device=device)
        self._seed = seed
        self._mesh = mesh
        self._sharded = self.hasher.sharded(mesh) if mesh is not None else None
        self._tree = None  # lazy: most corpora never hit the long path
        self._bloom = None
        if approx_items is not None:
            from ..hash.distributed import DeviceShardedBloom

            self._bloom = DeviceShardedBloom(
                n_items=int(approx_items), seed=seed ^ 0xB100, mesh=mesh,
                probe_transport=probe_transport, device=device)
        self.seen: set[int] = set()

    def _fingerprints(self, items, backend=None) -> np.ndarray:
        """(B,) uint64 variable-length fingerprints, one launch per batch
        (one a shard with a mesh)."""
        if self._sharded is not None and backend is None:
            return self._sharded.hash_batch(items)[:, 0]
        return self.hasher.hash_batch(items, backend=backend)[:, 0]

    def check_and_add(self, tokens) -> bool:
        """True if new (admitted), False if duplicate."""
        fp = int(self._fingerprints([np.atleast_1d(tokens)], backend="host")[0])
        if fp in self.seen:
            return False
        self.seen.add(fp)
        return True

    def check_and_add_batch(self, items) -> np.ndarray:
        """(B,) bool admission mask; duplicates WITHIN the batch keep only
        their first occurrence. One hash launch for the whole batch."""
        if len(items) == 0:
            return np.zeros(0, bool)
        return self._admit(self._fingerprints(items))

    def _admit(self, fps) -> np.ndarray:
        """Admission over precomputed fingerprints. Exact mode: arrival
        order, first occurrence (in the batch or before) wins. Approximate
        mode (`approx_items=`): the 64-bit fingerprints feed the
        device-sharded Bloom authority as 2-word keys (lo, hi) --
        pre-batch-state verdicts."""
        if self._bloom is not None:
            rows = [np.array([fp & 0xFFFFFFFF, fp >> 32], np.uint32)
                    for fp in map(int, np.asarray(fps, np.uint64))]
            return self._bloom.check_and_add_batch(rows)
        out = np.zeros(len(fps), bool)
        for i, fp in enumerate(map(int, fps)):
            if fp not in self.seen:
                self.seen.add(fp)
                out[i] = True
        return out

    def _tree_hasher(self):
        if self._tree is None:
            from ..hash.tree import TreeHasher, TreeSpec

            self._tree = TreeHasher(TreeSpec(seed=self._seed),
                                    device=self.hasher.device, mesh=self._mesh)
        return self._tree

    def add_documents(self, docs, *, long_words: int = 1 << 12) -> np.ndarray:
        """(B,) bool admission mask over documents of ANY length.

        Documents shorter than `long_words` ride the one-launch batched
        fingerprint; documents at or past it get tree fingerprints
        (`hash.tree`, one leaf launch each). Routing depends on length
        alone, so a document's verdict is stable across batch
        compositions. First occurrence wins, in arrival order.
        """
        docs = [np.asarray(d, np.uint32).reshape(-1) for d in docs]
        if len(docs) == 0:
            return np.zeros(0, bool)
        fps = np.zeros(len(docs), np.uint64)
        short = [i for i, d in enumerate(docs) if len(d) < long_words]
        if short:
            fps[short] = self._fingerprints([docs[i] for i in short])
        if len(short) < len(docs):
            th = self._tree_hasher()
            for i, d in enumerate(docs):
                if len(d) >= long_words:
                    fps[i] = th.fingerprint(d)
        return self._admit(fps)
