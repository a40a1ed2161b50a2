"""Multi-shard scale-out of the `Hasher` engine: sharded hashing and a
device-sharded Bloom filter.

The port of `repro.hash.distributed`, bit-identical to it. The reference's
`shard_map` over a 1-D mesh is a single-controller program, and so is this
module: one Python object takes the global batch, loops over the mesh's
shards -- each runs its part on its own device, one engine launch per shard
per call -- and returns global results. The mesh may hold one device
several times (`parallel.sharding`): D logical shards of one card run the
same bucketing, exchange and owned-range scatter as D cards would.

The reference's three collectives are private helpers over per-shard
tensor lists: `_all_gather` (every shard receives the concatenation),
`_all_to_all` (shard d receives bucket d of every shard) and `_psum` (a sum
onto the mesh's first device). Between distinct cards they copy onto the
receiver with ``non_blocking=True``; between logical shards of one card
they are copies within it.

- `ShardedHasher` -- wraps a `Hasher`; `__call__`/`shard_ids`/
  `probe_indices` split the rows into D contiguous blocks, hash each on its
  shard and gather; `hash_batch` is the host-convenience twin. Hashing is
  row-independent, so every result equals the single-device `Hasher`'s.
- `DeviceShardedBloom` -- shard d owns the contiguous bit range
  [d*m_local, (d+1)*m_local) of the global array. Probes use the SAME
  `h mod m` formula as the single-device `BloomFilter`, reduced inside the
  engine kernel, so every membership decision is the reference's. How the
  probes reach their owners is the `ProbeTransport`: ``"routed"``
  (default) buckets each shard's probes by owner and exchanges only owned
  ones, ``"all_gather"`` replicates the (B, k) matrix, ``"host"`` replays
  the per-batch host round-trip. `add_batch` reads nothing back on the
  in-graph transports; `contains_batch` and `check_and_add_batch` read the
  verdict and the overflow flags in one transfer.

PyTorch has no scatter that drops out-of-range indices (the reference's
``mode="drop"``): each shard's byte array has one extra byte, a drop slot
at m_local that starts set. Every probe a shard does not own -- a foreign
one or the -1 sentinel of a padding row -- is sent to that slot before it
reaches an index operation, so a scatter there changes nothing and a read
there counts no miss.
"""
from __future__ import annotations

import dataclasses
import math
import typing
import warnings

import numpy as np
import torch

from ..core import limbs
from ..core.device import as_tokens
from ..kernels.autotune import pow2_at_least
from ..parallel.sharding import Mesh, data_mesh, home_device, mesh_axis_size
from .hasher import Hasher, _stack_ragged
from .service import ShardReply
from .spec import HashSpec


def _bucket_rows(B: int, D: int) -> int:
    """Rows of a staged batch: D * pow2(ceil(B/D)), the reference's row
    policy (`_bucket_shape`), so each shard's probe count -- and with it
    the routed bucket capacity and `stats` -- is the reference's. The
    reference's width bucketing bounds its jit cache; the port has none to
    bound and hashes each batch at its own width."""
    return D * pow2_at_least(max(1, -(-B // D)))


class ProbeBucketOverflow(RuntimeError):
    """A routed probe exchange overflowed its static per-destination bucket
    capacity (raised only under `ProbeTransport(on_overflow="error")`; the
    default policy falls back to the all_gather transport instead).  The
    filter state is ALWAYS repaired before this raises -- decisions already
    returned and bits already set remain bit-identical to `BloomFilter`."""


@dataclasses.dataclass(frozen=True)
class ProbeTransport:
    """How `DeviceShardedBloom` moves probe indices between shards.

    kinds (all three bit-identical to the single-device `BloomFilter`):
      "routed"      default -- bucket each shard's (B/D, k) probes by owning
                    bit range and exchange ONLY owned probes with one
                    all_to_all (~capacity_factor/D the index bytes of
                    all_gather, plus each probe's row); per-item verdicts
                    come back via ONE psum of miss counts keyed by row.
      "all_gather"  replicate the full (B, k) probe matrix to every shard.
      "host"        per-batch host round-trip: hash_batch -> numpy `h % m`
                    -> a replicated operand.

    Bucket capacity is static, as in the reference (where jit needs fixed
    shapes): each destination receives at most `capacity(P, D)` of a
    shard's P = (B/D)*k probes. Strong universality spreads probes
    uniformly over owners, so the expected load is P/D and
    `capacity_factor` is the headroom. Overflow is detected on the device
    (truncated probes raise a per-shard flag) and `on_overflow` picks the
    recovery: "fallback" replays the batch through the all_gather surface
    (bit-identical, counted in `stats["overflow_fallbacks"]`), "error"
    repairs the filter the same way and then raises `ProbeBucketOverflow`.
    """

    kind: str = "routed"
    capacity_factor: float = 1.25
    capacity_slack: int = 16
    on_overflow: str = "fallback"

    _KINDS = ("host", "all_gather", "routed")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(
                f"probe_transport kind {self.kind!r} not in {self._KINDS}")
        if self.on_overflow not in ("fallback", "error"):
            raise ValueError(
                f"on_overflow {self.on_overflow!r} not in "
                "('fallback', 'error')")
        if not (self.capacity_factor > 0):
            raise ValueError("capacity_factor must be > 0")
        if self.capacity_slack < 0:
            raise ValueError("capacity_slack must be >= 0")

    @classmethod
    def of(cls, value) -> "ProbeTransport":
        """Resolve the constructor spec: a kind string or an instance."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(kind=value)
        raise TypeError(
            f"probe_transport must be a str or ProbeTransport, got "
            f"{type(value).__name__}")

    def capacity(self, n_probes: int, n_devices: int) -> int:
        """Static per-destination bucket capacity for a shard's `n_probes`
        probes over `n_devices` owners. Clamped to n_probes (a bucket can
        never need more), so with the default factor >= 1 a 1-shard mesh
        is structurally overflow-free; a deliberately tiny factor can still
        overflow anywhere -- that is the chaos-test knob."""
        cap = -(-int(n_probes * self.capacity_factor) // n_devices)
        return max(1, min(int(n_probes), cap + self.capacity_slack))


_UNSET = object()  # sentinel: distinguishes in_graph_mod=absent from =True


# -- the collectives, over per-shard tensor lists ----------------------------

def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x if x.device == device else x.to(device, non_blocking=True)


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _all_gather(parts, devices):
    """Tiled all_gather along dim 0: shard d receives cat(parts) on its
    device (a buffer of its own, as a real exchange gives it)."""
    return [torch.cat([_to(p, dev) for p in parts]) for dev in devices]


def _all_to_all(send, devices):
    """Tiled all_to_all (split and concat along dim 0): `send[s]` is shard
    s's (D, ...) buckets; shard d receives the (D, ...) stack of every
    shard's bucket d, sender order."""
    return [torch.stack([_to(buf[d], dev) for buf in send])
            for d, dev in enumerate(devices)]


def _psum(parts, device):
    """Sum of the shards' tensors, on `device`."""
    return torch.stack([_to(p, device) for p in parts]).sum(0)


# -- sharded hashing ------------------------------------------------------------

class ShardedHasher:
    """A `Hasher` scaled out over a mesh data axis.

    The wrapped hasher's keys are replicated (a copy per distinct shard
    device; logical shards of one device share them). The (B, N) batch is
    split into D contiguous row blocks, each shard runs the fused K-hash
    engine on its block (one launch), and the results gather back in row
    order onto the batch's device. Every hash is a pure function of its own
    row, so the output equals the single-device engine's.
    """

    def __init__(self, hasher: Hasher, mesh: Mesh | None = None,
                 axis: str = "data"):
        self.hasher = hasher
        if mesh is None:
            dev = hasher.device
            mesh = data_mesh(device="cuda" if dev.type == "cuda" else dev)
        self.mesh = mesh
        if axis not in self.mesh.axis_names:
            raise ValueError(
                f"mesh has axes {self.mesh.axis_names}, no {axis!r}")
        self.axis = axis
        self._replicas: dict = {}   # device -> (source hasher, its copy there)
        self._wide64: ShardedHasher | None = None

    @property
    def n_shards(self) -> int:
        return mesh_axis_size(self.mesh, self.axis)

    @property
    def devices(self) -> "tuple[torch.device, ...]":
        return self.mesh.devices

    @property
    def spec(self) -> HashSpec:
        return self.hasher.spec

    def ensure(self, max_len: int) -> "ShardedHasher":
        """Grow the wrapped hasher's key planes in place (the Philox streams
        extend bit-exactly; the replicas follow on their next use)."""
        self.hasher = self.hasher.ensure(max_len)
        return self

    def replica(self, device: torch.device) -> Hasher:
        """The wrapped hasher with its keys on `device`."""
        h = self.hasher
        if device == h.device:
            return h
        src, copy = self._replicas.get(device, (None, None))
        if src is not h:
            copy = Hasher(h.keys.to(device), h.spec, _mkb=h._mkb)
            self._replicas[device] = (h, copy)
        return copy

    def _map(self, fn, tokens, lengths):
        """fn(shard hasher, rows, lengths) on each shard's contiguous row
        block (rows padded to a multiple of D, length code 0, as the
        reference pads), gathered in row order: ((B, ...) tensor on the
        batch's device, batch shape)."""
        home = tokens.device if isinstance(tokens, torch.Tensor) else self.devices[0]
        toks = as_tokens(tokens, home)
        batch_shape, N = toks.shape[:-1], toks.shape[-1]
        toks = toks.reshape(-1, N)
        lens = (None if lengths is None else torch.as_tensor(
            lengths, device=home).reshape(-1).to(torch.int32))
        B, D = toks.shape[0], self.n_shards
        b = -(-max(B, 1) // D)
        if b * D != B:
            toks = torch.cat([toks, toks.new_zeros(b * D - B, N)])
            if lens is not None:
                lens = torch.cat([lens, lens.new_zeros(b * D - B)])
        outs = []
        for d, dev in enumerate(self.devices):
            rows = slice(d * b, (d + 1) * b)
            outs.append(fn(self.replica(dev), _to(toks[rows], dev),
                           None if lens is None else _to(lens[rows], dev)))
        return torch.cat([_to(o, home) for o in outs])[:B], batch_shape

    def __call__(self, tokens, lengths=None) -> torch.Tensor:
        """Sharded twin of `Hasher.__call__`: (..., N) tokens -> (..., K)
        int64 32-bit hashes or (..., K, 2) halves, B/D rows per shard."""
        out, batch_shape = self._map(lambda h, t, l: h(t, l), tokens, lengths)
        return out.reshape(*batch_shape, *out.shape[1:])

    def shard_ids(self, tokens, n_shards: int, lengths=None) -> torch.Tensor:
        """Sharded twin of `Hasher.shard_ids`: Lemire-reduced routing ids,
        computed per shard over the partitioned batch."""
        out, batch_shape = self._map(
            lambda h, t, l: h.shard_ids(t, n_shards, l), tokens, lengths)
        return out.reshape(batch_shape)

    def probe_indices(self, tokens, plan, lengths=None) -> torch.Tensor:
        """Sharded twin of `Hasher.probe_indices`: (..., N) tokens ->
        (..., K) int64 Bloom probe indices in [0, m), each shard reducing
        its own rows inside its engine launch."""
        plan = limbs.as_plan(plan)
        out, batch_shape = self._map(
            lambda h, t, l: h.probe_indices(t, plan, l), tokens, lengths)
        return out.reshape(*batch_shape, self.spec.n_hashes)

    # -- host-convenience batched engine --------------------------------------

    def hash_batch(self, tokens, *, lengths=None,
                   out_bits: int | None = None) -> np.ndarray:
        """Sharded twin of `Hasher.hash_batch`: dense or ragged host items
        in, (B, K) uint32/uint64 numpy out, hashed B/D rows per shard,
        equal to the single-device `Hasher.hash_batch`."""
        spec = self.spec
        out_bits = spec.out_bits if out_bits is None else out_bits
        toks, ragged_lens = _stack_ragged(tokens)
        if lengths is None:
            if ragged_lens is not None and not spec.variable_length:
                raise ValueError(
                    "ragged input requires variable_length=True; pass a "
                    "dense (B, N) array for fixed-length hashing")
            lengths = ragged_lens
        N = toks.shape[1]
        sharded = self
        if out_bits == 64 and spec.out_bits == 32:
            # widen the OUTPUT only: same key streams, full accumulators
            # (the widened twin is cached with its key replicas)
            if self.hasher._mkb is None:
                raise ValueError("64-bit output needs the Hasher's key buffer")
            if self._wide64 is None:
                self._wide64 = ShardedHasher(
                    Hasher.from_keys(self.hasher._mkb, spec.with_(out_bits=64),
                                     max_len=N, device=self.hasher.device),
                    self.mesh, self.axis)
            sharded = self._wide64
        sharded.ensure(N)
        out = sharded(toks, lengths).cpu().numpy().astype(np.uint64)
        if out_bits == 64:
            return (out[..., 0] << np.uint64(32)) | out[..., 1]
        if spec.out_bits == 64:
            return out[..., 0].astype(np.uint32)  # the finished >>32 hash
        return out.astype(np.uint32)


# -- the device-sharded Bloom filter --------------------------------------------

class _Staged(typing.NamedTuple):
    """A batch staged on the shards: per-shard (b, N) int32 rows, (b,)
    int32 lengths and (b,) bool row-valid masks; B real rows of Bp."""

    toks: list
    lens: list
    valid: list
    B: int
    Bp: int


def _pack(g: torch.Tensor, b: int, k: int, D: int, cap: int, m_local: int):
    """One shard's (b, k) int32 global probes (-1 on padding rows) -> its
    (D, cap) send buffers of global index and sender-local row, and whether
    a bucket overflowed (a 0-d bool tensor; no host sync).

    Probe g belongs to shard g // m_local; a stable sort by owner fills
    bucket d with the shard's probes of owner d in flat order (the
    reference's first-fit pack), so each bucket's rows are non-decreasing.
    Unused slots hold index -1 and row b; sentinel probes sort to owner D,
    which is never sent; probes past `cap` are not sent and raise the flag.
    """
    gf = g.reshape(-1)
    n = gf.shape[0]
    dest = torch.where(gf >= 0, gf // m_local, D)
    owner, order = torch.sort(dest, stable=True)
    edges = torch.searchsorted(
        owner, torch.arange(D + 1, dtype=owner.dtype, device=g.device))
    counts = edges[1:] - edges[:-1]
    j = torch.arange(cap, device=g.device)
    ok = j[None, :] < counts[:, None]
    si = order[(edges[:-1, None] + j[None, :]).clamp(max=n - 1)]
    send_g = torch.where(ok, gf[si], -1)
    send_r = torch.where(ok, si // k, b).to(torch.int32)
    return send_g, send_r, (counts > cap).any()


def pack_bits(bits: torch.Tensor, m: int) -> torch.Tensor:
    """(>= m,) uint8 bit bytes -> (ceil(m/64),) int64 tensor holding the u64
    words of the host `BloomFilter` layout (bit i is bit i % 64 of word
    i // 64), computed where `bits` lies."""
    n_words = -(-m // 64)
    x = bits[:m]
    if n_words * 64 > m:
        x = torch.cat([x, x.new_zeros(n_words * 64 - m)])
    x = x.reshape(-1, 8)
    byte = x[:, 0].clone()
    for j in range(1, 8):
        byte |= x[:, j] << j
    return byte.view(torch.int64)  # little-endian: byte i of a word is bits 8i..


class DeviceShardedBloom:
    """k-probe Bloom filter whose bit array is range-partitioned over the
    mesh data axis: shard d owns global bits [d*m_local, (d+1)*m_local).

    Decision compatibility: the same (m, k, seed) and the same global probe
    formula `h_j mod m` as the single-device `BloomFilter`, so the set of
    global bits lit by any key sequence -- and every membership decision --
    is the reference's; only bit placement is distributed. Storage is one
    byte a bit (m_local + 1 bytes a shard, the last the drop slot).

    Each shard hashes its B/D staged rows and reduces them mod m in its
    engine launch. The `probe_transport` moves the (B/D, k) probes to the
    shards that own their bits (see `ProbeTransport`):
      add_batch             ZERO host reads on the in-graph transports
                            (routed overflow flags are deferred)
      contains_batch        one read: the verdicts and the flags
      check_and_add_batch   one read: verdicts against the pre-batch
                            state, then the scatter
    `bytes_moved` counts the bytes the collectives (and the host
    transport's upload) move, from their shapes.

    Routed bucket overflow: add launches stay read-free by deferring the
    flag read -- the flags of up to `_settle_every` pending adds are read
    together at the next verdict-returning call (or `bits` read).
    Truncated scatters only ever light a SUBSET of the correct bits, so
    recovery replays the overflowed batches through the all_gather
    surface: bit union makes the repair exact. A routed
    `check_and_add_batch` scatters only after its read, so an overflowed
    call reruns through all_gather against untouched bits.

    `in_graph_mod=` is DEPRECATED (one-warning shim): True meant
    `probe_transport="all_gather"`, False the `"host"` round-trip.
    `device` (default: the mesh's first device, else the card) holds the
    hasher; `mesh=None` is `data_mesh(device=device)`.
    """

    _settle_every = 8  # max deferred routed adds before flags materialize

    def __init__(self, n_items: int, fp_rate: float = 1e-3, seed: int = 0xB100,
                 mesh: Mesh | None = None, axis: str = "data",
                 in_graph_mod=_UNSET,
                 probe_transport: "ProbeTransport | str" = "routed",
                 family: str = "multilinear", device=None):
        if in_graph_mod is not _UNSET:
            warnings.warn(
                "DeviceShardedBloom(in_graph_mod=...) is deprecated; pass "
                "probe_transport='all_gather' (was True) or 'host' (was "
                "False) -- see repro_torch.hash.distributed.ProbeTransport",
                DeprecationWarning, stacklevel=2)
            probe_transport = "all_gather" if in_graph_mod else "host"
        self.transport = ProbeTransport.of(probe_transport)

        # same sizing as data.dedup.BloomFilter -- decision identity needs
        # identical (m, k) for identical inputs
        self.m = max(64, int(-n_items * math.log(fp_rate) / (math.log(2) ** 2)))
        self.k = max(1, int(self.m / n_items * math.log(2)))
        if self.m >= 1 << 31:
            raise ValueError(f"m={self.m} bits exceeds the int32 probe-index "
                             "domain; shard the filter by keyspace first")
        mesh = data_mesh(device=device) if mesh is None else mesh
        self.sharded = ShardedHasher(Hasher.from_spec(HashSpec(
            family=family, n_hashes=self.k, out_bits=64,
            variable_length=True, seed=seed),
            device=home_device(mesh, device)), mesh, axis)
        self.mesh, self.axis = self.sharded.mesh, self.sharded.axis
        self.plan = limbs.ModPlan.for_modulus(self.m)
        self.m_local = -(-self.m // self.n_shards)
        self._bits = []
        for dev in self.devices:
            shard = torch.zeros(self.m_local + 1, dtype=torch.uint8, device=dev)
            shard[self.m_local] = 1  # the drop slot reads as set
            self._bits.append(shard)
        self._pending: list = []  # routed adds with unread overflow flags
        self.stats = {"overflow_fallbacks": 0}
        self.bytes_moved = 0

    @property
    def n_shards(self) -> int:
        return self.sharded.n_shards

    @property
    def devices(self) -> "tuple[torch.device, ...]":
        return self.sharded.devices

    @property
    def in_graph_mod(self) -> bool:
        """Deprecated read-only view of the old boolean flag: True for any
        in-graph transport, False only for the host round-trip."""
        return self.transport.kind != "host"

    @property
    def bits(self) -> torch.Tensor:
        """A copy of the (m_local * D,) uint8 global bit array on the
        mesh's first device. A read settles any pending routed adds first,
        so observers always see repaired, `BloomFilter`-identical state."""
        self._settle()
        return torch.cat([_to(b[:self.m_local], self.devices[0])
                          for b in self._bits])

    def words(self) -> torch.Tensor:
        """The global bits as the host `BloomFilter`'s u64 words, an int64
        tensor of ceil(m/64) on the mesh's first device."""
        return pack_bits(self.bits, self.m)

    # -- shard-local bit operations -------------------------------------------

    def _local(self, g: torch.Tensor, d: int) -> torch.Tensor:
        """Global probe indices (-1 = sentinel) -> int64 offsets into shard
        d's bytes: owned probes at their local offset, every other probe at
        the drop slot m_local (never wrapped, never out of range)."""
        loc = g.to(torch.int64) - d * self.m_local
        return torch.where((loc >= 0) & (loc < self.m_local), loc, self.m_local)

    def _set(self, d: int, g: torch.Tensor) -> None:
        self._bits[d].index_fill_(0, self._local(g, d).reshape(-1), 1)

    def _misses(self, d: int, g: torch.Tensor) -> torch.Tensor:
        """(R, k) global probes -> (R,) int32 unset owned bits of shard d."""
        idx = self._local(g, d)
        probe = self._bits[d].index_select(0, idx.reshape(-1)).view(idx.shape)
        return (probe == 0).sum(1, dtype=torch.int32)

    def _add_global(self, G) -> None:
        """Set every shard's owned bits of its replicated (R, k) probes."""
        for d, g in enumerate(G):
            self._set(d, g)

    def _present_global(self, G) -> torch.Tensor:
        """(R,) bool membership over replicated probes: ONE psum of the
        shards' miss counts."""
        misses = [self._misses(d, g) for d, g in enumerate(G)]
        self.bytes_moved += _nbytes(misses)
        return _psum(misses, self.devices[0]) == 0

    # -- staging and the three transports ---------------------------------------

    def _stage(self, items) -> _Staged:
        """Stack host items and upload each shard's row block to its device:
        Bp = `_bucket_rows(B, D)` rows; padding rows are invalid (their
        probes become the -1 sentinel)."""
        toks, lens = _stack_ragged(items)
        B, N = toks.shape
        if lens is None:
            lens = np.full(B, N, np.int64)
        D = self.n_shards
        Bp = _bucket_rows(B, D)
        b = Bp // D
        toks_p = np.zeros((Bp, N), np.uint32)
        toks_p[:B] = toks
        lens_p = np.zeros(Bp, np.int32)
        lens_p[:B] = lens
        valid = np.zeros(Bp, bool)
        valid[:B] = True
        self.sharded.ensure(N)
        t_toks = torch.from_numpy(toks_p.view(np.int32))
        t_lens, t_valid = torch.from_numpy(lens_p), torch.from_numpy(valid)
        rows = [slice(d * b, (d + 1) * b) for d in range(D)]
        return _Staged(
            [t_toks[r].to(dev) for r, dev in zip(rows, self.devices)],
            [t_lens[r].to(dev) for r, dev in zip(rows, self.devices)],
            [t_valid[r].to(dev) for r, dev in zip(rows, self.devices)], B, Bp)

    def _probes_local(self, st: _Staged) -> list:
        """Each shard's (b, k) int32 global probes of its own rows (one
        engine launch a shard), -1 on padding rows."""
        out = []
        for d, dev in enumerate(self.devices):
            g = self.sharded.replica(dev).probe_indices(
                st.toks[d], self.plan, st.lens[d]).to(torch.int32)
            out.append(torch.where(st.valid[d][:, None], g, -1))
        return out

    def _gathered(self, st: _Staged) -> list:
        """all_gather transport: the (Bp, k) probe matrix on every shard."""
        G = _all_gather(self._probes_local(st), self.devices)
        self.bytes_moved += _nbytes(G)
        return G

    def _probes(self, items) -> np.ndarray:
        """Host round-trip (`probe_transport="host"`): (B, k) int32 GLOBAL
        probe indices -- the full 64-bit hashes mod m, exactly the
        single-device `BloomFilter` formula, hashed B/D rows per shard then
        reduced with numpy's `%` on the host."""
        h = self.sharded.hash_batch(items)  # (B, k) uint64
        return (h % np.uint64(self.m)).astype(np.int32)

    def _replicated(self, items) -> list:
        """Host transport: the host's (B, k) probes uploaded to each shard."""
        g = torch.from_numpy(self._probes(items))
        G = [g.to(dev) for dev in self.devices]
        self.bytes_moved += _nbytes(G)
        return G

    def _route(self, st: _Staged, with_rows: bool):
        """Routed transport: bucket each shard's probes by owner (`_pack`)
        and exchange only owned probes with one all_to_all -> (per-shard
        (D, cap) received indices, received rows or None, (D,) overflow
        flags on the first device, rows a shard)."""
        D, dev0 = self.n_shards, self.devices[0]
        g_local = self._probes_local(st)
        b, k = g_local[0].shape
        cap = self.transport.capacity(b * k, D)
        packed = [_pack(g, b, k, D, cap, self.m_local) for g in g_local]
        recv_g = _all_to_all([p[0] for p in packed], self.devices)
        recv_r = (_all_to_all([p[1] for p in packed], self.devices)
                  if with_rows else None)
        self.bytes_moved += _nbytes(recv_g) + (_nbytes(recv_r) if with_rows else 0)
        flags = torch.stack([_to(p[2], dev0) for p in packed])
        return recv_g, recv_r, flags, b

    def _present_routed(self, recv_g, recv_r, b: int) -> torch.Tensor:
        """(Bp,) bool membership from the received probes: each shard tests
        its owned probes and adds each miss to its row's count (sender s's
        row r is global row s*b + r; an unused slot's row b adds no miss),
        then ONE psum. A row's total is 0 iff all k of its global bits are
        set -- the all_gather verdict, duplicate probe indices included."""
        D = self.n_shards
        counts = []
        for d, dev in enumerate(self.devices):
            idx = self._local(recv_g[d], d)
            miss = (self._bits[d].index_select(0, idx.reshape(-1)) == 0
                    ).to(torch.int32)
            row = (torch.arange(D, device=dev)[:, None] * b + recv_r[d]).reshape(-1)
            c = torch.zeros(D * b + 1, dtype=torch.int32, device=dev)
            counts.append(c.index_add_(0, row, miss)[:D * b])
        self.bytes_moved += _nbytes(counts)
        return _psum(counts, self.devices[0]) == 0

    # -- the launch parts (no host reads) ---------------------------------------

    def _add_staged(self, st: _Staged) -> None:
        """add_batch after staging: launches only."""
        if self.transport.kind == "all_gather":
            self._add_global(self._gathered(st))
            return
        recv_g, _, flags, _ = self._route(st, with_rows=False)
        self._add_global(recv_g)
        self._pending.append((flags, st))
        if len(self._pending) >= self._settle_every:
            self._settle()

    def _verdict_staged(self, st: _Staged, insert: bool):
        """contains/admit after staging, launches only: ((Bp + D,) uint8 --
        presence then the routed overflow flags, read in one transfer --
        and the routed probes still to scatter, or None)."""
        if self.transport.kind == "all_gather":
            G = self._gathered(st)
            present = self._present_global(G)
            if insert:
                self._add_global(G)
            return present.to(torch.uint8), None
        recv_g, recv_r, flags, b = self._route(st, with_rows=True)
        present = self._present_routed(recv_g, recv_r, b)
        return torch.cat([present, flags]).to(torch.uint8), recv_g

    def _settle(self) -> None:
        """Read the overflow flags of pending routed adds (one transfer).
        Batches whose flag fired were truncated -- their scatters lit a
        SUBSET of the correct bits -- so replay exactly those through the
        all_gather surface. Under `on_overflow="error"` the repair still
        runs, then the typed error surfaces the misconfiguration."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        fired = torch.stack([f for f, _ in pending]).any(1).cpu().numpy()
        replay = [st for (_, st), hit in zip(pending, fired) if hit]
        if not replay:
            return
        self.stats["overflow_fallbacks"] += len(replay)
        for st in replay:
            self._add_global(self._gathered(st))
        if self.transport.on_overflow == "error":
            raise ProbeBucketOverflow(
                f"{len(replay)} routed add batch(es) overflowed the static "
                f"bucket capacity (capacity_factor="
                f"{self.transport.capacity_factor}); state repaired via "
                "all_gather replay -- raise capacity_factor/capacity_slack "
                "or use probe_transport='all_gather'")

    # -- public surface ---------------------------------------------------------

    def owner_shards(self, items) -> np.ndarray:
        """(B,) home shard per item via the Lemire multiply-shift reduction
        on the finished 32-bit hash (load accounting / routing for
        multi-host admission; probe ownership is the contiguous range map)."""
        from .sharding import reduce_range

        h32 = (self.sharded.hash_batch(items)[:, 0]
               >> np.uint64(32)).astype(np.uint32)
        return reduce_range(h32, self.n_shards)

    def add_batch(self, items) -> None:
        """Admit a batch: per-shard hash + mod m, the probe exchange and the
        owned-range scatter -- no host read on the in-graph transports (the
        routed overflow flag is deferred to the next settle point)."""
        if len(items) == 0:
            return
        if self.transport.kind == "host":
            self._add_global(self._replicated(items))
            return
        self._add_staged(self._stage(items))

    def contains_batch(self, items) -> np.ndarray:
        """(B,) bool membership; one read of the verdict (with the routed
        overflow flags)."""
        if len(items) == 0:
            return np.zeros(0, bool)
        if self.transport.kind == "host":
            return self._present_global(self._replicated(items)).cpu().numpy()
        self._settle()
        st = self._stage(items)
        out = self._verdict_staged(st, insert=False)[0].cpu().numpy()
        if out[st.Bp:].any():
            self._overflowed("contains_batch")
            return self._present_global(self._gathered(st)).cpu().numpy()[:st.B]
        return out[:st.B].astype(bool)

    def check_and_add_batch(self, items) -> np.ndarray:
        """(B,) admission mask: True where the item was not already present.
        Verdicts are evaluated against the pre-batch state (duplicates
        WITHIN a batch all admit -- the batched round-trip contract; stream
        items through `contains`+`add` per sub-batch when arrival-order
        dedup inside a batch matters)."""
        if len(items) == 0:
            return np.zeros(0, bool)
        if self.transport.kind == "host":
            G = self._replicated(items)
            present = self._present_global(G)
            self._add_global(G)
            return ~present.cpu().numpy()
        self._settle()
        st = self._stage(items)
        out, recv_g = self._verdict_staged(st, insert=True)
        out = out.cpu().numpy()
        if out[st.Bp:].any():
            # truncated exchange: nothing was scattered; rerun against the
            # untouched pre-call bits via all_gather
            self._overflowed("check_and_add_batch")
            G = self._gathered(st)
            present = self._present_global(G)
            self._add_global(G)
            return ~present.cpu().numpy()[:st.B]
        if recv_g is not None:
            self._add_global(recv_g)
        return out[:st.B] == 0

    def _overflowed(self, op: str) -> None:
        self.stats["overflow_fallbacks"] += 1
        if self.transport.on_overflow == "error":
            raise ProbeBucketOverflow(
                f"routed {op} overflowed the static bucket capacity "
                f"(capacity_factor={self.transport.capacity_factor}); the "
                "filter state is unchanged -- raise capacity_factor/"
                "capacity_slack or use probe_transport='all_gather'")

    def add(self, item) -> None:
        self.add_batch([np.atleast_1d(item)])

    def __contains__(self, item) -> bool:
        return bool(self.contains_batch([np.atleast_1d(item)])[0])


# ---------------------------------------------------------------------------
# admission-service backend adapter
# ---------------------------------------------------------------------------

class FilterShardBackend:
    """Adapts a batch filter to the admission service's shard protocol.

    Any object with `check_and_add_batch` / `contains_batch` / `add_batch`
    works: the host `data.dedup.BloomFilter` (arrival-order in-batch
    semantics -- the service's decision-identity reference) or a
    `DeviceShardedBloom` (verdicts against the pre-batch state, the
    documented batched-round-trip contract).

    Replies carry the paper's own integrity fingerprint
    (`ShardReply.for_payload`), and non-ping requests are IDEMPOTENT: the
    reply for each `req_id` is cached (bounded LRU), so a retry after a
    dropped reply returns the ORIGINAL verdict -- at-least-once delivery
    never flips an admit into a reject.
    """

    def __init__(self, filt, cache_size: int = 64):
        import collections

        self.filt = filt
        self._replies: "dict[int, ShardReply]" = collections.OrderedDict()
        self._cache_size = int(cache_size)
        self.calls = {"admit": 0, "contains": 0, "add": 0, "ping": 0,
                      "replayed": 0}

    def serve(self, request) -> ShardReply:
        if request.op == "ping":
            self.calls["ping"] += 1
            return ShardReply.for_payload(np.zeros(0, bool))
        if request.req_id and request.req_id in self._replies:
            self.calls["replayed"] += 1
            return self._replies[request.req_id]
        items = list(request.items)
        self.calls[request.op] += 1
        if request.op == "admit":
            payload = self.filt.check_and_add_batch(items)
        elif request.op == "contains":
            payload = self.filt.contains_batch(items)
        elif request.op == "add":
            self.filt.add_batch(items)
            payload = np.ones(len(items), bool)
        else:
            raise ValueError(f"unknown shard op {request.op!r}")
        reply = ShardReply.for_payload(payload)
        if request.req_id:
            self._replies[request.req_id] = reply
            while len(self._replies) > self._cache_size:
                self._replies.pop(next(iter(self._replies)))
        return reply


def bloom_shard_backends(
        n_shards: int, n_items: int, fp_rate: float = 1e-3,
        seed: int = 0xB100, *, mesh: Mesh | None = None,
        probe_transport: "ProbeTransport | str" = "routed", device=None,
) -> "list[FilterShardBackend]":
    """`n_shards` keyspace-partitioned Bloom backends for the admission
    service (each shard's filter sized for its 1/n share of the items; the
    service's Lemire routing keeps loads uniform by strong universality).

    With `mesh=` each shard's filter is a `DeviceShardedBloom` whose bits
    range-partition over the mesh data axis under the given
    `probe_transport`; verdicts are then against the pre-batch state (the
    batched contract) instead of the host filter's arrival order -- the
    service's per-shard batching makes both orders converge to the same
    filter state. Without a mesh they are host `BloomFilter`s hashing on
    `device` (the card unless the caller passes another)."""
    per = max(1, -(-int(n_items) // int(n_shards)))
    if mesh is not None:
        return [FilterShardBackend(DeviceShardedBloom(
                    n_items=per, fp_rate=fp_rate, seed=seed, mesh=mesh,
                    probe_transport=probe_transport, device=device))
                for _ in range(int(n_shards))]
    from ..data.dedup import BloomFilter

    return [FilterShardBackend(BloomFilter(n_items=per, fp_rate=fp_rate,
                                           seed=seed, device=device))
            for _ in range(int(n_shards))]
