"""repro_torch.hash -- the hashing engine of the port: `HashSpec` + `Hasher`.

    spec = HashSpec(family="multilinear", n_hashes=4, out_bits=64)
    hasher = Hasher.from_spec(spec, max_len=128)      # keys on cuda
    slots = hasher(tokens)                             # (B, K, 2) int64
    hb = hasher.hash_batch(ragged_items)               # numpy, one launch

Submodules: spec (HashSpec), hasher (Hasher), keyring (bounded-LRU
defaults), sharding (Lemire-reduced shard routing), streaming (two-level
incremental fingerprints, fingerprint_bytes), tree (tree fingerprints of
long inputs and pytrees).
"""
from . import keyring, sharding, spec, streaming, tree  # noqa: F401
from .hasher import Hasher  # noqa: F401
from .sharding import reduce_range, shard_assignment  # noqa: F401
from .spec import DEFAULT_SEED, FAMILY_NAMES, HashSpec  # noqa: F401
from .streaming import StreamState, fingerprint_bytes, stream_digest_host  # noqa: F401
from .tree import (PytreeFingerprint, TreeHasher, TreeSpec, TreeStream,  # noqa: F401
                   default_tree_hasher, fingerprint_pytree,
                   root_of_leaf_fingerprints, stream_tree)
