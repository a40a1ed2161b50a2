"""repro_torch.hash -- the hashing engine of the port: `HashSpec` + `Hasher`.

    spec = HashSpec(family="multilinear", n_hashes=4, out_bits=64)
    hasher = Hasher.from_spec(spec, max_len=128)      # keys on cuda
    slots = hasher(tokens)                             # (B, K, 2) int64
    hb = hasher.hash_batch(ragged_items)               # numpy, one launch

Submodules: spec (HashSpec), hasher (Hasher), keyring (bounded-LRU
defaults), sharding (Lemire-reduced shard routing), streaming (two-level
incremental fingerprints, fingerprint_bytes), tree (tree fingerprints of
long inputs and pytrees), distributed (sharded hashing and the
device-sharded Bloom filter over a `parallel.Mesh`), service (the
fault-tolerant admission service), faults (seeded fault injection).

The exports are the reference's (`repro.hash`) but for `HashPlan` and
`default_plan`: the port has no plan object (a Hasher's device is its
plan).
"""
from . import distributed, faults, keyring, service, sharding, spec, streaming, tree  # noqa: F401
from .distributed import (  # noqa: F401
    DeviceShardedBloom, FilterShardBackend, ProbeBucketOverflow,
    ProbeTransport, ShardedHasher, bloom_shard_backends)
from .faults import FaultEvent, FaultPlan, FaultyTransport  # noqa: F401
from .hasher import Hasher  # noqa: F401
from .service import (  # noqa: F401
    AdmissionService, BreakerConfig, CircuitBreaker, InProcessTransport,
    RetryPolicy, ShardReply, ShardRequest, VirtualClock)
from .sharding import reduce_range, shard_assignment  # noqa: F401
from .spec import DEFAULT_SEED, FAMILY_NAMES, HashSpec  # noqa: F401
from .streaming import StreamState, fingerprint_bytes, stream_digest_host  # noqa: F401
from .tree import (PytreeFingerprint, TreeHasher, TreeSpec, TreeStream,  # noqa: F401
                   default_tree_hasher, fingerprint_pytree,
                   root_of_leaf_fingerprints, stream_tree)
