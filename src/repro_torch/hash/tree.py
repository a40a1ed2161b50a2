"""HalftimeHash-style tree fingerprints for long token streams.

The port of `repro.hash.tree`, bit-identical to it. Construction (the
tree of HalftimeHash, arXiv 2104.08865, on the paper's MULTILINEAR
leaves):

  1. the token stream is split into fixed `leaf_words` leaf blocks;
  2. ALL leaves are hashed in one fused engine launch (`Hasher.__call__`,
     K 1, fixed length, 64-bit surface): a leaf's digest is
     ``m1 + sum k_i * t_i mod 2^64`` (or its family's counterpart);
  3. leaf digests are combined by a logarithmic pairwise fold: level `l`
     compresses each (a, b) digest pair to

         m1_l + k1_l*a_lo + k2_l*a_hi + k3_l*b_lo + k4_l*b_hi  (mod 2^64)

     under fresh level-l keys (an odd trailing node is promoted
     unchanged); the root is finalized the same way against a 64-bit
     length tag under level-0 keys.

The collision bound of the whole tree is `core.theory.tree_collision_bound`.

Key schedule: leaf keys are the wrapped Hasher's stream-0 Philox words;
fold level `l` uses words [5l, 5l+5) of an independent stream seeded
``stream0_seed ^ _FOLD_TAG``. All key material is a pure function of the
`TreeSpec` seed.

On the device, digests are int64 tensors holding u64 bits; a wrapped int64
multiply-add is exact mod 2^64. The fold is PyTorch operations on the
digests where they lie (a handful a level), the leaves one launch of the
engine kernel; only the root is read back. Unlike the reference there is
no pow2 leaf bucketing (no jit cache to bound): a host-known length folds
over exactly its leaves. `digest_tokens` takes a 0-d tensor `n_tokens` and
masks past it without a host sync. With `mesh=` the leaf launch shards over
the mesh data axis (`ShardedHasher`: one launch a shard); digests do not
depend on the mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import as_tokens
from ..core.keys import KeyBuffer
from ..core.limbs import MASK32, hi32, lo32
from ..core.pytree import flatten_with_paths
from ..parallel.sharding import home_device
from .hasher import Hasher
from .spec import DEFAULT_SEED, FAMILY_NAMES, HashSpec

# Domain-separation tag for the fold key stream: distinct from every leaf
# stream (seed ^ j*GOLDEN64) and from streaming._L2_TAG.
_FOLD_TAG = 0x7EE0_F01D_5CA1_AB1E

#: u64 key words per fold level: (m1, k1, k2, k3, k4).
FOLD_WORDS = 5
#: fold levels whose keys go to the device (level 0 finalizes; a tree of
#: 2^63 leaves folds in 63 levels)
_LEVELS = 65
_MASK64 = (1 << 64) - 1


def fold_seed(stream0_seed: int) -> int:
    return (int(stream0_seed) ^ _FOLD_TAG) % (1 << 64)


def _s64(x: int) -> int:
    """A u64 value as the int64 of the same bits."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static shape of a tree fingerprint: leaf size, leaf family, seed.

    Two TreeHashers with equal specs produce bit-identical digests -- the
    spec (not the device, not the update chunking) is the identity.
    """

    leaf_words: int = 256
    family: str = "multilinear"
    seed: int = DEFAULT_SEED

    def __post_init__(self):
        if self.leaf_words < 1:
            raise ValueError(f"leaf_words must be >= 1, got {self.leaf_words}")
        if self.family not in FAMILY_NAMES:
            raise KeyError(
                f"unknown engine family {self.family!r}; have {FAMILY_NAMES}")

    def leaf_spec(self) -> HashSpec:
        """The fixed-length 64-bit single-stream spec hashing the leaves."""
        return HashSpec(family=self.family, n_hashes=1, out_bits=64,
                        variable_length=False, seed=self.seed)


def _halves(nodes: torch.Tensor) -> torch.Tensor:
    """(2P,) int64 u64 digests -> (P, 4) int64 u32 values (a_lo, a_hi,
    b_lo, b_hi) of consecutive pairs: the little-endian words of the int64s."""
    return nodes.contiguous().view(torch.int32).view(-1, 4).to(torch.int64) & MASK32


def _fold_pair(keys: torch.Tensor, m1: int, x: torch.Tensor) -> torch.Tensor:
    """One strongly universal pair compression: (P, 4) u32 values x and a
    level's (4,) int64 keys (k1..k4) and m1 (an int64 value) -> (P,) int64
    u64 bits of m1 + k1*x0 + k2*x1 + k3*x2 + k4*x3 mod 2^64."""
    return (x * keys).sum(dim=1) + m1


class TreeHasher:
    """Tree fingerprints over u32 token streams on one device.

    Surfaces:
      - ``digest_tokens(tokens, n_tokens=None)`` -- tensors only, no host
        sync: (T,) tokens -> (2,) int64 (hi, lo) u32 halves of the root.
        `n_tokens` may be a 0-d tensor: padding past it is masked, so
        callers can bucket T.
      - ``fingerprint(tokens)`` / ``fingerprint_bytes(data)`` /
        ``fingerprint_array(arr)`` -> int (one read of the root).
      - ``stream()`` -- incremental `TreeStream` (split-invariant).
      - ``digest_host(tokens)`` -- numpy twin, bit-identical.

    With ``mesh=`` the leaf launch shards over the mesh data axis `axis`;
    the device (default: the mesh's first) holds the keys, the fold and
    the gathered leaf digests.
    """

    def __init__(self, spec: TreeSpec = TreeSpec(), *, device=None, mesh=None,
                 axis: str = "data"):
        self.spec = spec
        self.hasher = Hasher.from_spec(spec.leaf_spec(), max_len=spec.leaf_words,
                                       device=home_device(mesh, device))
        self.sharded = (self.hasher.sharded(mesh, axis)
                        if mesh is not None else None)
        self._fold = KeyBuffer(seed=fold_seed(self.hasher.spec.stream_seeds()[0]),
                               initial=FOLD_WORDS * 8)
        words = self._fold.u64(FOLD_WORDS * _LEVELS).reshape(_LEVELS, FOLD_WORDS)
        self._m1 = [_s64(int(m)) for m in words[:, 0]]
        self._keys = torch.from_numpy(words[:, 1:].view(np.int64).copy()).to(
            self.device)

    @property
    def device(self) -> torch.device:
        return self.hasher.device

    # -- fold key schedule ---------------------------------------------------

    def level_keys_u64(self, level: int) -> np.ndarray:
        """(5,) uint64 fold key words of `level` (0 = root finalization)."""
        lo = FOLD_WORDS * level
        return self._fold.u64(lo + FOLD_WORDS)[lo : lo + FOLD_WORDS]

    # -- device digest ---------------------------------------------------------

    def _leaf_digests(self, rows: torch.Tensor) -> torch.Tensor:
        """(L, leaf_words) int32 rows -> (L,) int64 u64 leaf digests: one
        fused engine launch, or one a shard with a mesh (hi = out[:, 0, 0],
        lo = out[:, 0, 1])."""
        out = self.sharded(rows) if self.sharded is not None else self.hasher(rows)
        return (out[:, 0, 0] << 32) | out[:, 0, 1]

    def _fold_impl(self, nodes: torch.Tensor, t, tag) -> torch.Tensor:
        """Logarithmic pairwise fold + root finalization over (L,) int64
        u64 leaf digests -> 0-d int64 u64 root.

        Real nodes occupy the `t`-prefix. With a Python int `t` the fold
        runs over that prefix only; with a 0-d tensor (a device-side
        length) a right node i of fold level l (1 pairs the leaves) is
        real iff (2i + 1) * 2^(l - 1) < t,
        and a real left node with a pad right one is PROMOTED unchanged,
        so pad content never reaches a real node and no host sync is
        needed. `tag` is the length tag: a Python int, or a 0-d int64
        tensor of a u32 tag (the reference's tag_hi = 0)."""
        traced = isinstance(t, torch.Tensor)
        if not traced:
            nodes = nodes[:t]
        right = (2 * torch.arange(nodes.shape[0] // 2, device=nodes.device) + 1
                 if traced else None)
        level = 1
        while nodes.shape[0] > 1:
            L = nodes.shape[0]
            pairs = nodes[: L - L % 2]
            comb = _fold_pair(self._keys[level], self._m1[level], _halves(pairs))
            if traced:
                real = (right[: comb.shape[0]] << (level - 1)) < t
                comb = torch.where(real, comb, pairs[0::2])
            # an odd trailing node has no right partner: promoted unchanged
            nodes = torch.cat([comb, nodes[-1:]]) if L % 2 else comb
            level += 1
        # root finalization: (root_lo, root_hi, tag_lo, tag_hi), level 0
        root = (nodes.contiguous().view(torch.int32).to(torch.int64) & MASK32)
        k = self._keys[0]
        if isinstance(tag, torch.Tensor):
            return (root * k[:2]).sum() + k[2] * tag + self._m1[0]
        if not 0 <= tag < (1 << 64):
            raise ValueError(f"length tag {tag} out of u64 range")
        m1, _, _, k3, k4 = map(int, self.level_keys_u64(0))
        return (root * k[:2]).sum() + _s64(m1 + k3 * (tag & MASK32)
                                           + k4 * (tag >> 32))

    def _root(self, words: torch.Tensor, n: int, tag: int) -> torch.Tensor:
        """(L * leaf_words,) int32 tokens on the device, zero past the `n`
        real ones, L = max(1, ceil(n / leaf_words)) -> 0-d u64 root."""
        lw = self.spec.leaf_words
        nodes = self._leaf_digests(words.view(-1, lw))
        return self._fold_impl(nodes, nodes.shape[0], tag)

    def _n_leaves(self, n: int) -> int:
        return max(1, -(-n // self.spec.leaf_words))

    def _pad(self, toks: torch.Tensor, n: int) -> torch.Tensor:
        """A device tensor of n int32 tokens zero-padded to whole leaves."""
        pad = self._n_leaves(n) * self.spec.leaf_words - n
        return torch.cat([toks, toks.new_zeros(pad)]) if pad else toks

    @staticmethod
    def _int(root: torch.Tensor) -> int:
        return int(root.item()) & _MASK64

    def digest_tokens(self, tokens, n_tokens=None) -> torch.Tensor:
        """(T,) tokens -> (2,) int64 (hi, lo) u32 halves of the root digest,
        with no host sync.

        `n_tokens` (default T; an int or a 0-d tensor) is the TRUE stream
        length: tokens at index >= n_tokens are masked to zero and the tree
        shape is derived from it, so any zero-padded bucketing of the same
        stream digests identically.
        """
        toks = as_tokens(tokens, self.device).reshape(-1)
        T, lw = toks.shape[0], self.spec.leaf_words
        pad = (-T) % lw if T else lw
        if pad:
            toks = torch.cat([toks, toks.new_zeros(pad)])
        if n_tokens is None or not isinstance(n_tokens, torch.Tensor):
            n = T if n_tokens is None else int(n_tokens)
            if n < toks.shape[0]:
                toks = torch.cat([toks[:n], toks.new_zeros(toks.shape[0] - n)])
            nodes = self._leaf_digests(toks.view(-1, lw))
            root = self._fold_impl(nodes, self._n_leaves(n), n & MASK32)
        else:
            n = n_tokens.to(device=self.device, dtype=torch.int64)
            idx = torch.arange(toks.shape[0], device=self.device)
            toks = torch.where(idx < n, toks, 0)
            nodes = self._leaf_digests(toks.view(-1, lw))
            t = torch.clamp((n + (lw - 1)) // lw, min=1)
            root = self._fold_impl(nodes, t, n & MASK32)
        return torch.stack([hi32(root), lo32(root)])

    def fingerprint(self, tokens) -> int:
        """64-bit tree fingerprint of a token sequence (numpy, a list or a
        tensor; a tensor on the device is hashed where it lies): one launch
        for all leaves, the fold, one read of the root."""
        toks = as_tokens(tokens, self.device).reshape(-1)
        n = toks.shape[0]
        return self._int(self._root(self._pad(toks, n), n, tag=n))

    def fingerprint_bytes(self, data) -> int:
        """64-bit tree fingerprint of a byte string: bytes are packed into
        little-endian uint32 words (zero-padded) and the BYTE length is the
        finalization tag, so buffers differing only in trailing pad bytes
        digest differently."""
        raw = np.frombuffer(data, np.uint8)
        n_words = -(-len(raw) // 4)
        buf = np.zeros(self._n_leaves(n_words) * self.spec.leaf_words, np.uint32)
        buf.view(np.uint8)[: len(raw)] = raw
        words = torch.from_numpy(buf.view(np.int32)).to(self.device)
        return self._int(self._root(words, n_words, tag=len(raw)))

    def fingerprint_array(self, arr) -> int:
        """Tree fingerprint of one array's (a tensor's or a numpy array's)
        raw C-order bytes, equal to `fingerprint_bytes(arr.tobytes())`. The
        bytes are viewed as words and zero-padded on the hasher's device: a
        tensor already there is hashed where it lies, with no host round
        trip; a host array is uploaded once. bf16 and other 2-byte types
        hash as their raw words."""
        if isinstance(arr, torch.Tensor):
            u8 = arr.detach().contiguous().reshape(-1).view(torch.uint8)
        else:
            arr = np.ascontiguousarray(arr)
            if not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
                return self.fingerprint_bytes(arr.tobytes())
            u8 = torch.from_numpy(arr.reshape(-1).view(np.uint8))
        u8 = u8.to(self.device)
        n_bytes = u8.shape[0]
        n_words = -(-n_bytes // 4)
        pad = self._n_leaves(n_words) * self.spec.leaf_words * 4 - n_bytes
        if pad or u8.data_ptr() % 4:
            u8 = torch.cat([u8, u8.new_zeros(pad)])
        return self._int(self._root(u8.view(torch.int32), n_words, tag=n_bytes))

    # -- incremental ----------------------------------------------------------

    def stream(self, leaf_batch: int = 1024) -> "TreeStream":
        """Fresh incremental tree stream; `leaf_batch` complete leaves are
        buffered before each fused flush launch."""
        return TreeStream(self, leaf_batch=leaf_batch)

    # -- numpy twin -----------------------------------------------------------

    def _leaf_digests_host(self, rows) -> np.ndarray:
        """(L, leaf_words) -> (L,) uint64 leaf digests on the vectorized
        hostref path (bit-identical to the fused engine launch)."""
        return self.hasher.hash_batch(np.asarray(rows, np.uint32),
                                      backend="host")[:, 0]

    def _fold_host(self, digests: np.ndarray, tag: int) -> int:
        """Numpy-uint64 fold + finalization over (L,) uint64 leaf digests."""
        mask = np.uint64(0xFFFFFFFF)
        with np.errstate(over="ignore"):
            nodes = np.asarray(digests, np.uint64)
            level = 1
            while len(nodes) > 1:
                m1, k1, k2, k3, k4 = self.level_keys_u64(level)
                a, b = nodes[0 : 2 * (len(nodes) // 2) : 2], nodes[1::2]
                comb = (m1 + k1 * (a & mask) + k2 * (a >> np.uint64(32))
                        + k3 * (b & mask) + k4 * (b >> np.uint64(32)))
                nodes = (comb if len(nodes) % 2 == 0
                         else np.concatenate([comb, nodes[-1:]]))
                level += 1
            m1, k1, k2, k3, k4 = self.level_keys_u64(0)
            root = nodes[0]
            t = np.uint64(tag)
            out = (m1 + k1 * (root & mask) + k2 * (root >> np.uint64(32))
                   + k3 * (t & mask) + k4 * (t >> np.uint64(32)))
        return int(out)

    def digest_host(self, tokens, tag: int | None = None) -> int:
        """Numpy/hostref reference of `fingerprint` -- the ground truth the
        device path is pinned against (leaf AND fold bit-identity)."""
        toks = np.asarray(tokens, np.uint32).reshape(-1)
        lw = self.spec.leaf_words
        n = len(toks)
        leaves = self._n_leaves(n)
        buf = np.zeros(leaves * lw, np.uint32)
        buf[:n] = toks
        digs = self._leaf_digests_host(buf.reshape(leaves, lw))
        return self._fold_host(digs, n if tag is None else tag)

    def __repr__(self):
        mesh = "" if self.sharded is None else f", shards={self.sharded.n_shards}"
        return f"TreeHasher({self.spec}, device={self.device}{mesh})"


class TreeStream:
    """Incremental tree fingerprint: absorb token blocks in ANY split, get
    the same digest as the one-shot `TreeHasher.fingerprint` of the
    concatenated stream.

    Blocks are staged on the hasher's device. Once `leaf_batch` complete
    leaves are buffered, every complete leaf is flushed through one fused
    engine launch; the leaf digests stay on the device (8 bytes a leaf)
    and the fold tail runs there, so `digest_int` reads back only the
    root. `total` and the buffered count `_nbuf` are Python ints.
    """

    def __init__(self, hasher: TreeHasher, leaf_batch: int = 1024):
        if leaf_batch < 1:
            raise ValueError("leaf_batch must be >= 1")
        self.hasher = hasher
        self.leaf_batch = int(leaf_batch)
        self._lw = hasher.spec.leaf_words
        self._parts: list[torch.Tensor] = []  # buffered, not yet full leaves
        self._nbuf = 0                        # tokens across _parts
        self._digests: list[torch.Tensor] = []  # (c,) int64 leaf digests per flush
        self.total = 0                        # tokens absorbed overall

    def update(self, tokens) -> "TreeStream":
        toks = as_tokens(tokens, self.hasher.device).reshape(-1)
        if toks.shape[0] == 0:
            return self
        self._parts.append(toks)
        self._nbuf += toks.shape[0]
        self.total += toks.shape[0]
        if self._nbuf >= self.leaf_batch * self._lw:
            self._flush()
        return self

    def _flush(self, final: bool = False) -> None:
        lw = self._lw
        c = self._nbuf // lw
        if final:
            c = max(1 if self.total == 0 else -(-self._nbuf // lw), c)
        if c == 0:
            return
        buf = (torch.cat(self._parts) if self._parts else
               torch.zeros(0, dtype=torch.int32, device=self.hasher.device))
        take = buf[: c * lw]
        if take.shape[0] < c * lw:  # final partial leaf: zero-pad
            take = torch.cat([take, take.new_zeros(c * lw - take.shape[0])])
        self._digests.append(self.hasher._leaf_digests(take.view(c, lw)))
        rest = buf[c * lw :]
        self._parts = [rest.clone()] if rest.shape[0] else []
        self._nbuf = rest.shape[0]

    def digest_int(self) -> int:
        """Finalize (non-destructively) to the 64-bit root fingerprint:
        flush the partial leaf, fold the device-resident leaf digests and
        read back the root -- the only host transfer."""
        parts, nbuf, digests = list(self._parts), self._nbuf, list(self._digests)
        self._flush(final=True)
        nodes = (torch.cat(self._digests) if len(self._digests) > 1
                 else self._digests[0])
        th = self.hasher
        root = th._fold_impl(nodes, nodes.shape[0], self.total)
        # restore: digest_int() must not change what a later update() absorbs
        self._parts, self._nbuf, self._digests = parts, nbuf, digests
        return th._int(root)


def stream_tree(spec: TreeSpec = TreeSpec(), *, device=None, mesh=None,
                leaf_batch: int = 1024) -> TreeStream:
    """Incremental tree fingerprint over a default (cached) TreeHasher."""
    return default_tree_hasher(spec, device=device, mesh=mesh).stream(
        leaf_batch=leaf_batch)


# -- default instances (deterministic, like keyring) --------------------------

_DEFAULT: dict = {}


def default_tree_hasher(spec: TreeSpec = TreeSpec(), *, device=None,
                        mesh=None) -> TreeHasher:
    """Process-cached TreeHasher for a spec, device and mesh (a pure
    function of the spec, so the cache changes cost, never values); at
    most 16."""
    key = (spec, home_device(mesh, device), mesh)
    th = _DEFAULT.get(key)
    if th is None:
        th = _DEFAULT[key] = TreeHasher(spec, device=key[1], mesh=mesh)
        while len(_DEFAULT) > 16:
            _DEFAULT.pop(next(iter(_DEFAULT)))
    return th


# -- pytree fingerprints ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PytreeFingerprint:
    """Root digest + per-leaf digests of one pytree, in flatten order."""

    root: int
    leaves: "tuple[tuple[str, int], ...]"

    def leaf_map(self) -> "dict[str, int]":
        return dict(self.leaves)


def root_of_leaf_fingerprints(pairs, hasher: TreeHasher | None = None) -> int:
    """Root digest over ordered (path, leaf_fp) pairs: the tree fingerprint
    of the ``[path_fp, leaf_fp]`` word stream, covering both structure
    (paths and order) and content. One launch per path and one for the
    root. Shared by `fingerprint_pytree` and the checkpoint manifest."""
    th = hasher if hasher is not None else default_tree_hasher()
    words = np.zeros(4 * len(pairs), np.uint32)
    for i, (path, fp) in enumerate(pairs):
        pfp = th.fingerprint_bytes(path.encode())
        words[4 * i : 4 * i + 4] = (
            pfp & 0xFFFFFFFF, pfp >> 32, fp & 0xFFFFFFFF, fp >> 32)
    return th.fingerprint(words)


def fingerprint_pytree(tree, hasher: TreeHasher | None = None, *, device=None,
                       mesh=None) -> PytreeFingerprint:
    """Flatten (`core.pytree`) -> per-leaf-array tree digests of the raw
    bytes (`fingerprint_array`: one leaf launch per array, a tensor hashed
    where it lies) -> root digest over (path, digest) pairs. `mesh=`
    shards each leaf launch (see `TreeHasher`)."""
    th = (hasher if hasher is not None
          else default_tree_hasher(device=device, mesh=mesh))
    leaves = tuple((path, th.fingerprint_array(leaf))
                   for path, leaf in flatten_with_paths(tree))
    return PytreeFingerprint(root=root_of_leaf_fingerprints(leaves, th),
                             leaves=leaves)
