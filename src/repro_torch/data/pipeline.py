"""Hash-powered data pipeline: the paper's families doing production work.

The port of `repro.data.pipeline`, route for route.

Every routing decision is a strongly universal hash of the *content*:
  - train/eval split:   h(doc) mod 100 < eval_pct  (stable under reshards)
  - shard assignment:   h(doc) mod n_shards        (uniform loads: §1)
  - global shuffle:     sort by salted h(doc)      (reproducible epochs)
  - dedup:              64-bit fingerprint set / Bloom filter
All three routing hashes (dedup fingerprint, split, shard) are independent
MULTILINEAR functions evaluated as ONE K=3 pass through a single `Hasher`
(DESIGN.md §3/§6) whose spec binds the three purpose seeds as explicit key
streams: `admit_batch` hashes a whole batch of documents in a single
launch; `admit` uses the bit-identical vectorized host path, so streaming
and batched admission route every document the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..hash import Hasher, HashSpec
from ..parallel.sharding import home_device

# Per-purpose base seeds for the fused triple (stream order: fp, split, shard)
_FP_SEED = 0xF1F0
_SPLIT_SEED = 0xDA7A ^ 0x5EA7
_SHARD_SEED = 0xDA7A ^ 0x511A


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int
    batch_size: int            # per-host batch
    eval_pct: int = 1          # percent of docs to eval split
    n_shards: int = 1
    shard_id: int = 0
    dedup: bool = True
    shuffle_salt: int = 0
    pack: bool = True
    vocab_size: int = 50000


class HashPipeline:
    """Deterministic, shardable, dedup'ing token pipeline.

    Documents stream in as (doc_id, token array); out come packed
    (tokens, labels, mask) batches for this shard. Every decision is
    reproducible from content + salt alone (no state to checkpoint beyond
    the stream position), and every document costs exactly one 3-function
    hash evaluation -- fused into one launch per batch in `admit_batch`.
    """

    def __init__(self, cfg: PipelineConfig, mesh=None, admission=None,
                 device=None):
        self.cfg = cfg
        self.device = home_device(mesh, device)
        self.seen_fingerprints: set[int] = set()
        # optional fault-tolerant dedup: when an `AdmissionService`
        # (hash.service) is supplied, the duplicate decision is delegated
        # to its hierarchical L1/L2 filters (approximate, Bloom fp_rate;
        # shard-scalable; keeps deciding through backend outages per its
        # degradation policy) instead of the exact local set. Split/shard
        # routing is unchanged either way.
        self.admission = admission
        # fp / split / shard as one fused 3-hash Hasher (explicit seeds)
        self.route_hasher = Hasher.from_spec(HashSpec(
            family="multilinear", n_hashes=3, out_bits=64,
            variable_length=True, seed=(_FP_SEED, _SPLIT_SEED, _SHARD_SEED)),
            device=self.device)
        # mesh-parallel routing: batched hashing partitioned over the mesh
        # data axis (the same values -> the same routing decisions)
        self._sharded = (self.route_hasher.sharded(mesh)
                         if mesh is not None else None)
        self.stats = {"docs": 0, "dup": 0, "eval": 0, "other_shard": 0, "kept": 0}

    def _route_hashes(self, docs, backend: str | None = None) -> np.ndarray:
        """(B, 3) uint64 (fingerprint, split, shard) -- one launch/batch.

        The fingerprint keeps all 64 accumulator bits; split/shard decisions
        use only the high 32 (`>> 32` in _route_one): strong universality
        (Thm 3.1) holds for the finished hash, not the accumulator's low
        bits. With a mesh, one launch a shard.
        """
        if self._sharded is not None and backend is None:
            return self._sharded.hash_batch(docs)
        return self.route_hasher.hash_batch(docs, backend=backend)

    def _route_one(self, fp: int, h_split: int, h_shard: int,
                   dup: bool | None = None) -> str:
        c = self.cfg
        if c.dedup:
            if dup is None:  # local exact-set authority
                dup = fp in self.seen_fingerprints
                if not dup:
                    self.seen_fingerprints.add(fp)
            if dup:
                self.stats["dup"] += 1
                return "dup"
        if h_split % 100 < c.eval_pct:
            self.stats["eval"] += 1
            return "eval"
        if c.n_shards > 1 and h_shard % c.n_shards != c.shard_id:
            self.stats["other_shard"] += 1
            return "other_shard"
        self.stats["kept"] += 1
        return "train"

    def admit(self, tokens: np.ndarray) -> str:
        """Route one document: 'train' | 'eval' | 'dup' | 'other_shard'."""
        self.stats["docs"] += 1
        h = self._route_hashes([np.atleast_1d(tokens)], backend="host")[0]
        dup = None
        if self.admission is not None and self.cfg.dedup:
            dup = not bool(self.admission.admit_batch(
                [np.atleast_1d(tokens)])[0])
        return self._route_one(int(h[0]), int(h[1]) >> 32, int(h[2]) >> 32,
                               dup=dup)

    def admit_batch(self, docs) -> list[str]:
        """Route a batch of documents with ONE fused 3-hash launch.

        Bit-identical to per-document `admit` (duplicates within the batch
        are caught in arrival order); stats update as if streamed. With an
        admission service attached, the whole batch's dedup verdicts come
        from one `AdmissionService.admit_batch` call (grouped per shard).
        """
        if len(docs) == 0:
            return []
        hashes = self._route_hashes(list(docs))
        self.stats["docs"] += len(docs)
        dups: list[bool | None] = [None] * len(docs)
        if self.admission is not None and self.cfg.dedup:
            dups = [not bool(ok)
                    for ok in self.admission.admit_batch(list(docs))]
        return [self._route_one(int(h[0]), int(h[1]) >> 32, int(h[2]) >> 32,
                                dup=d)
                for h, d in zip(hashes, dups)]

    def epoch_order(self, doc_hashes: np.ndarray, epoch: int) -> np.ndarray:
        """Reproducible global shuffle: argsort of salted re-hash."""
        words = np.empty((len(doc_hashes), 2), np.uint32)
        words[:, 0] = doc_hashes & 0xFFFFFFFF
        words[:, 1] = doc_hashes >> 32 if doc_hashes.dtype == np.uint64 else 0
        salted = Hasher.from_spec(HashSpec(
            family="multilinear_hm", variable_length=True,
            seed=0xE90C ^ (epoch * 0x9E37)), device=self.device)
        order_keys = salted.hash_batch(words, backend="host")[:, 0]
        return np.argsort(order_keys, kind="stable")

    def pack(self, docs: Iterator[np.ndarray]) -> Iterator[dict]:
        """Pack admitted docs into (B, T+1) windows -> tokens/labels/mask."""
        c = self.cfg
        buf = np.zeros(0, np.int32)
        rows = []
        for doc in docs:
            if self.admit(doc) != "train":
                continue
            buf = np.concatenate([buf, doc.astype(np.int32)])
            while len(buf) >= c.seq_len + 1:
                rows.append(buf[: c.seq_len + 1])
                buf = buf[c.seq_len :]  # one-token overlap for labels
                if len(rows) == c.batch_size:
                    block = np.stack(rows)
                    yield {
                        "tokens": block[:, :-1],
                        "labels": block[:, 1:],
                        "mask": np.ones((c.batch_size, c.seq_len), np.float32),
                    }
                    rows = []
