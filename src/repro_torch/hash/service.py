"""`AdmissionService` -- fault-tolerant hierarchical admission over sharded
filters.

The port of `repro.hash.service`, decision for decision: the same seeded
jitter, breaker transitions, event log and journal. The routing `Hasher`
and the L1 `BloomFilter` take `device=` (the card unless the caller passes
another), as the port's other consumers do; the rest is numpy and Python.

The paper's strong universality is what makes degraded-mode admission
*analyzable*: per-filter false-positive bounds hold independently, so when
the remote L2 shard is down and a local L1 Bloom filter answers alone, the
error budget of "fail open" is the L1 filter's own FP bound -- a provable
number, not a shrug (DESIGN.md §8).

Pieces, smallest first:

- `VirtualClock` -- a deterministic monotonic clock. Deadlines, backoff
  sleeps and circuit-breaker reset timers all read it, so every timing
  decision in a test or fault-injection run is reproducible to the bit.
- `ShardRequest` / `ShardReply` -- the wire format of one shard call. Every
  reply carries `fingerprint_bytes(payload)` computed by the *backend*; the
  service re-fingerprints on receipt, so a corrupted reply is detected and
  retried, never trusted (the paper's own hash doing integrity duty, same
  as the checkpointer).
- `InProcessTransport` -- the zero-latency base transport routing requests
  to per-shard backends (see `distributed.FilterShardBackend`). The
  fault-injection wrapper (`hash.faults.FaultyTransport`) layers
  timeouts/drops/latency/corruption/crashes on top of any transport.
- `RetryPolicy` -- per-attempt deadline + bounded retries with exponential
  backoff and DETERMINISTIC jitter (the jitter draw is a pure function of
  (service seed, shard, backoff ordinal), so two runs of the same fault
  plan back off identically).
- `CircuitBreaker` -- per-shard closed -> open -> half-open machine. Open
  breakers fail fast (no transport call); after `reset_timeout_s` the next
  admission sends an explicit `ping` health probe, and only a probe success
  closes the breaker (triggering L1->L2 reconciliation).
- `AdmissionService` -- routes items to shard backends by the Lemire
  `(h*n)>>32` reduction (`hash.sharding.reduce_range`, the same
  `owner_shards` formula as `DeviceShardedBloom`), with a local L1
  `BloomFilter` in front: an L1 hit answers "duplicate" WITHOUT a shard
  round-trip (the hot set never pays L2 latency, faulty or not), an L1 miss
  goes to the owner shard. When a shard is unavailable the configurable
  degradation policy decides: `fail_open` admits L1 misses (bounded extra
  duplicates: the L1 FP budget), `fail_closed` rejects them (never admits
  anything the healthy service would reject). Every item decided without
  its L2 shard is journaled and replayed into the shard on recovery, so the
  global filter state CONVERGES to the fault-free run's state.

In-batch semantics: items are grouped per owner shard and decided by the
backend in arrival order (`check_and_add_batch`), and L1 inserts happen
after each shard reply -- so a healthy run's decisions are bit-identical to
streaming the items one at a time. Retries are made idempotent by a
per-request id the backend caches replies under: a retry after a dropped
reply returns the ORIGINAL verdict instead of re-deciding (at-least-once
delivery never flips an admit into a reject).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .hasher import Hasher
from .spec import HashSpec
from .sharding import reduce_range
from .streaming import fingerprint_bytes

_ROUTE_SEED = 0xAD417  # "ADMIT": default routing-hash seed

_GOLDEN64 = 0x9E3779B97F4A7C15


def philox_for(a: int, b: int, c: int, d: int) -> np.random.Generator:
    """Deterministic Philox stream keyed on four integer fields (numpy
    takes a 2x64-bit key; golden-ratio mixing folds the fields in without
    practical collisions at service scale). Shared by the service's jitter
    draws and the fault plan's per-call decisions."""
    k0 = (int(a) * _GOLDEN64 + int(b)) % (1 << 64)
    k1 = (int(c) * _GOLDEN64 + int(d)) % (1 << 64)
    return np.random.Generator(np.random.Philox(
        key=np.array([k0, k1], np.uint64)))


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------

class VirtualClock:
    """Deterministic monotonic time: `sleep` advances, nothing else does.

    All service timing (deadlines, backoff, breaker reset windows) goes
    through a clock object so fault-injection runs are bit-reproducible and
    tests never block on real `time.sleep`. Swap in a wall-clock
    implementation (now=time.monotonic, sleep=time.sleep) for a live
    deployment; the service only calls `now()` and `sleep(dt)`.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self._t += max(0.0, float(dt))


# ---------------------------------------------------------------------------
# wire format + transport
# ---------------------------------------------------------------------------

class TransportError(Exception):
    """Base of every transport-level failure (retryable)."""


class ShardUnavailable(TransportError):
    """Connection refused / crashed shard / dropped reply."""


class DeadlineExceeded(TransportError):
    """The per-attempt deadline elapsed before a reply arrived."""


class CorruptReply(TransportError):
    """Reply payload does not match its fingerprint (integrity failure)."""


@dataclasses.dataclass(frozen=True)
class ShardRequest:
    """One call to one shard backend.

    op:      'admit' (check_and_add, arrival-order), 'contains', 'add'
             (blind insert -- reconciliation replay), or 'ping' (health
             probe, no items).
    items:   tuple of 1-D uint32 token rows routed to this shard.
    req_id:  idempotency key -- backends cache the reply per req_id, so a
             retried 'admit' returns the original verdict instead of
             re-deciding (a dropped reply must not flip admit -> reject).
    """

    op: str
    items: tuple = ()
    req_id: int = 0


@dataclasses.dataclass(frozen=True)
class ShardReply:
    """A shard's answer: (B,) bool payload + its 64-bit Multilinear
    fingerprint (`fingerprint_bytes` over the raw payload bytes), computed
    by the BACKEND so any on-the-wire corruption is detectable."""

    payload: np.ndarray
    fingerprint: int

    @classmethod
    def for_payload(cls, payload: np.ndarray) -> "ShardReply":
        payload = np.asarray(payload, bool)
        return cls(payload=payload,
                   fingerprint=fingerprint_bytes(payload.tobytes()))

    def verify(self) -> bool:
        return (isinstance(self.payload, np.ndarray)
                and self.payload.dtype == np.bool_
                and fingerprint_bytes(self.payload.tobytes())
                == self.fingerprint)


class InProcessTransport:
    """Zero-latency transport: request -> `backends[shard].serve(request)`.

    The degenerate healthy transport (same role as the size-1 mesh in §7:
    the production code path, minus the wire). Real deployments substitute
    an RPC transport with the same `call` signature; the fault harness
    wraps either.
    """

    def __init__(self, backends):
        self.backends = list(backends)

    @property
    def n_shards(self) -> int:
        return len(self.backends)

    def call(self, shard: int, request: ShardRequest,
             deadline_s: float | None = None) -> ShardReply:
        return self.backends[shard].serve(request)


# ---------------------------------------------------------------------------
# retry / backoff
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and deterministic jitter.

    Attempt k (0-based) sleeps ``min(max_backoff_s, base_backoff_s *
    multiplier**k) * (1 + jitter_frac * (u - 0.5))`` before retrying, where
    u in [0, 1) is drawn from a Philox stream keyed on (service seed,
    shard, backoff ordinal) -- jittered enough to de-synchronize real
    replicas, yet a pure function of the run's seeds, so fault-injection
    runs replay identically.
    """

    max_attempts: int = 3
    deadline_s: float = 0.05        # per-attempt reply deadline
    base_backoff_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 0.25
    jitter_frac: float = 0.5

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def backoff_s(self, attempt: int, u: float) -> float:
        base = min(self.max_backoff_s,
                   self.base_backoff_s * self.multiplier ** attempt)
        return base * (1.0 + self.jitter_frac * (float(u) - 0.5))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3      # consecutive failures to trip open
    reset_timeout_s: float = 0.25   # open -> half-open wait
    probe_successes: int = 1        # half-open probes needed to close


class CircuitBreaker:
    """Per-shard closed -> open -> half-open state machine.

    closed:    calls flow; `failure_threshold` CONSECUTIVE failures trip to
               open (one success resets the count).
    open:      calls fail fast (no transport attempt) until
               `reset_timeout_s` has elapsed on the service clock.
    half-open: one health probe is allowed through; `probe_successes`
               successes close the breaker, any failure re-opens it (and
               restarts the reset window).

    Transitions append to `transitions` as (time, from, to) -- the
    determinism contract tests replay and compare.
    """

    def __init__(self, cfg: BreakerConfig, clock: VirtualClock):
        self.cfg = cfg
        self.clock = clock
        self.state = "closed"
        self.failures = 0
        self.probe_wins = 0
        self.open_until = 0.0
        self.transitions: list[tuple[float, str, str]] = []

    def _move(self, to: str) -> None:
        if to != self.state:
            self.transitions.append((self.clock.now(), self.state, to))
            self.state = to

    def allow(self) -> bool:
        """May a call be attempted now? Open breakers turn half-open once
        the reset window has elapsed (the caller must then health-probe)."""
        if self.state == "open" and self.clock.now() >= self.open_until:
            self._move("half_open")
            self.probe_wins = 0
        return self.state != "open"

    def record_success(self) -> None:
        if self.state == "half_open":
            self.probe_wins += 1
            if self.probe_wins >= self.cfg.probe_successes:
                self._move("closed")
                self.failures = 0
        else:
            self.failures = 0

    def record_failure(self) -> None:
        if self.state == "half_open":
            self._trip()
            return
        self.failures += 1
        if self.failures >= self.cfg.failure_threshold:
            self._trip()

    def _trip(self) -> None:
        self._move("open")
        self.failures = 0
        self.open_until = self.clock.now() + self.cfg.reset_timeout_s


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

class AdmissionService:
    """Fault-tolerant hierarchical L1/L2 admission (see module docstring).

    policy: 'fail_open'  -- when a shard is unavailable, L1 misses ADMIT
                            (availability over exactness; the extra-duplicate
                            budget is the L1 filter's own FP bound);
            'fail_closed' -- L1 misses REJECT (exactness over availability;
                            never admits an item the healthy service would
                            reject, because every admit still required a
                            healthy not-present verdict).
    Either way L1-hit decisions never consult L2 at all, so they are
    bit-identical to the healthy path by construction, and every item
    decided without its shard is journaled for replay on recovery.
    """

    def __init__(self, transport, *, policy: str = "fail_open",
                 retry: RetryPolicy | None = None,
                 breaker: BreakerConfig | None = None,
                 clock: VirtualClock | None = None,
                 l1_items: int = 4096, l1_fp_rate: float = 1e-3,
                 seed: int = _ROUTE_SEED, max_journal: int = 100_000,
                 device=None):
        if policy not in ("fail_open", "fail_closed"):
            raise ValueError(f"unknown policy {policy!r}")
        self.transport = transport
        self.n_shards = int(transport.n_shards)
        if self.n_shards < 1:
            raise ValueError("need at least one shard backend")
        self.policy = policy
        self.retry = retry or RetryPolicy()
        self.clock = clock or VirtualClock()
        self.seed = int(seed)
        cfg = breaker or BreakerConfig()
        self.breakers = [CircuitBreaker(cfg, self.clock)
                         for _ in range(self.n_shards)]
        # routing hash: one 64-bit variable-length Multilinear function;
        # the owner shard is the Lemire reduction of its high 32 bits
        # (identical formula to DeviceShardedBloom.owner_shards).
        self.router = Hasher.from_spec(HashSpec(
            family="multilinear", n_hashes=1, out_bits=64,
            variable_length=True, seed=self.seed), device=device)
        from ..data.dedup import BloomFilter  # lazy: avoids an import cycle

        self.l1 = BloomFilter(n_items=l1_items, fp_rate=l1_fp_rate,
                              seed=self.seed ^ 0x11F1, device=device)
        self.max_journal = int(max_journal)
        self._journal: list[list[np.ndarray]] = [[] for _ in range(self.n_shards)]
        self._req_counter = 0
        self._backoff_counts = [0] * self.n_shards
        self.stats = {
            "admitted": 0, "rejected": 0, "l1_hits": 0, "l2_calls": 0,
            "retries": 0, "timeouts": 0, "unavailable": 0,
            "corrupt_replies": 0, "fast_fails": 0, "probes": 0,
            "breaker_opens": 0, "breaker_closes": 0,
            "degraded_decisions": 0, "l1_only_admits": 0,
            "reconciled_items": 0, "journal_dropped": 0,
        }
        #: deterministic event log: (clock time, kind, shard, detail) --
        #: the determinism contract (`tests/test_chaos.py`) replays a fault
        #: plan and asserts two runs produce identical logs.
        self.events: list[tuple[float, str, int, str]] = []
        #: per-item provenance of the last admit/contains batch:
        #: {'owner', 'l1_hit', 'degraded'} arrays (set by _decide_batch).
        self.last_info: dict[str, np.ndarray] = {}

    @classmethod
    def over_bloom_shards(cls, n_shards: int, n_items: int, *,
                          fp_rate: float = 1e-3, shard_seed: int = 0xB100,
                          mesh=None, probe_transport="routed",
                          device=None, **kwargs) -> "AdmissionService":
        """Service over `n_shards` in-process Bloom backends in one call.

        With `mesh=` every shard's L2 filter is a `DeviceShardedBloom`
        range-partitioned over the mesh data axis, moving probes under
        `probe_transport` (default "routed": one exchange of owned probes
        per call -- `hash.distributed.ProbeTransport`). `device` (default:
        the mesh's first device, else the card) holds the router, the L1
        filter and the host backends' hashing. Remaining kwargs go to the
        service constructor (policy/retry/clock/...)."""
        from ..parallel.sharding import home_device
        from .distributed import bloom_shard_backends  # lazy: import cycle

        device = home_device(mesh, device)
        backends = bloom_shard_backends(
            n_shards, n_items, fp_rate=fp_rate, seed=shard_seed, mesh=mesh,
            probe_transport=probe_transport, device=device)
        return cls(InProcessTransport(backends), device=device, **kwargs)

    # -- small helpers -------------------------------------------------------

    def _log(self, kind: str, shard: int, detail: str = "") -> None:
        self.events.append((self.clock.now(), kind, shard, detail))

    @property
    def degraded(self) -> bool:
        """True while any shard's breaker is not closed."""
        return any(b.state != "closed" for b in self.breakers)

    def owner_shards(self, items) -> np.ndarray:
        """(B,) owner shard per item: Lemire `(h*n)>>32` on the routing
        hash's high 32 bits (the `hash.sharding` reduction)."""
        h = self.router.hash_batch(items)[:, 0]
        h32 = (h >> np.uint64(32)).astype(np.uint32)
        return reduce_range(h32, self.n_shards)

    def _jitter_u(self, shard: int) -> float:
        """Deterministic jitter draw: pure function of (seed, shard,
        backoff ordinal) -- independent of wall time and of the other
        shards' call interleaving."""
        n = self._backoff_counts[shard]
        self._backoff_counts[shard] = n + 1
        return float(philox_for(self.seed, 0xBACC0FF, shard, n).random())

    # -- shard RPC with retry + breaker --------------------------------------

    def _attempt(self, shard: int, request: ShardRequest) -> ShardReply:
        """One transport attempt + integrity verification."""
        reply = self.transport.call(shard, request,
                                    deadline_s=self.retry.deadline_s)
        if not reply.verify():
            self.stats["corrupt_replies"] += 1
            self._log("corrupt_reply", shard, request.op)
            raise CorruptReply(f"shard {shard}: fingerprint mismatch")
        return reply

    def _probe(self, shard: int) -> bool:
        """Half-open health probe: one 'ping' through the transport."""
        self.stats["probes"] += 1
        self._log("probe", shard)
        try:
            self._attempt(shard, ShardRequest(op="ping"))
        except TransportError as e:
            self._log("probe_fail", shard, type(e).__name__)
            return False
        self._log("probe_ok", shard)
        return True

    def _call_shard(self, shard: int, request: ShardRequest) -> ShardReply | None:
        """Shard call under deadline/retry/backoff/breaker; None means the
        shard is unavailable (degradation policy takes over)."""
        br = self.breakers[shard]
        if not br.allow():
            self.stats["fast_fails"] += 1
            self._log("fast_fail", shard, request.op)
            return None
        if br.state == "half_open":
            ok = self._probe(shard)
            was_open = br.state
            (br.record_success if ok else br.record_failure)()
            if not ok:
                self.stats["breaker_opens"] += 1
                self._log("breaker_open", shard, "probe failed")
                return None
            if was_open == "half_open" and br.state == "closed":
                self.stats["breaker_closes"] += 1
                self._log("breaker_close", shard)
                self._reconcile(shard)
        for attempt in range(self.retry.max_attempts):
            try:
                reply = self._attempt(shard, request)
            except TransportError as e:
                if isinstance(e, DeadlineExceeded):
                    self.stats["timeouts"] += 1
                elif isinstance(e, ShardUnavailable):
                    self.stats["unavailable"] += 1
                self._log("attempt_fail", shard,
                          f"{request.op}#{attempt}:{type(e).__name__}")
                br.record_failure()
                if br.state == "open":
                    self.stats["breaker_opens"] += 1
                    self._log("breaker_open", shard,
                              f"{self.breakers[shard].cfg.failure_threshold}"
                              " consecutive failures")
                    return None
                if attempt + 1 < self.retry.max_attempts:
                    self.stats["retries"] += 1
                    delay = self.retry.backoff_s(attempt, self._jitter_u(shard))
                    self._log("backoff", shard, f"{delay:.6f}s")
                    self.clock.sleep(delay)
                continue
            br.record_success()
            return reply
        self._log("exhausted", shard, request.op)
        return None

    # -- journal + reconciliation --------------------------------------------

    def _journal_items(self, shard: int, rows: list[np.ndarray]) -> None:
        room = self.max_journal - len(self._journal[shard])
        if room < len(rows):
            self.stats["journal_dropped"] += len(rows) - max(0, room)
        self._journal[shard].extend(rows[: max(0, room)])

    def _reconcile(self, shard: int) -> None:
        """Replay the L1-only journal into a recovered shard ('add' op:
        blind idempotent insert), restoring convergence with a fault-free
        run's filter state. Runs on breaker close; if the shard fails again
        mid-replay the journal is retained for the next recovery."""
        rows = self._journal[shard]
        if not rows:
            return
        self._req_counter += 1
        req = ShardRequest(op="add", items=tuple(rows),
                           req_id=self._req_counter)
        if self._call_shard(shard, req) is None:
            self._log("reconcile_fail", shard, f"{len(rows)} items retained")
            return
        self._journal[shard] = []
        self.stats["reconciled_items"] += len(rows)
        self._log("reconcile", shard, f"{len(rows)} items")

    def reconcile_all(self, rounds: int = 8, wait: bool = True) -> bool:
        """Drive recovery to quiescence: probe every non-closed breaker
        (waiting out open reset windows on the service clock when `wait` --
        virtual clocks make that free) and replay outstanding journals, up
        to `rounds` passes, stopping early once every breaker is closed and
        every journal drained. Returns True when fully recovered. A still-
        crashed shard keeps its journal for the next call."""
        for _ in range(rounds):
            for shard in range(self.n_shards):
                br = self.breakers[shard]
                if br.state == "open" and wait:
                    self.clock.sleep(max(0.0, br.open_until - self.clock.now()))
                if br.state != "closed":
                    self._req_counter += 1
                    self._call_shard(shard, ShardRequest(
                        op="ping", req_id=self._req_counter))
                elif self._journal[shard]:
                    self._reconcile(shard)
            if not self.degraded and not any(self._journal):
                return True
        return not self.degraded and not any(self._journal)

    # -- admission -----------------------------------------------------------

    @staticmethod
    def _norm(items) -> list[np.ndarray]:
        return [np.atleast_1d(np.asarray(r)).astype(np.uint32) for r in items]

    def _decide_batch(self, items, insert: bool) -> np.ndarray:
        """Shared body of admit/contains: (B,) bool 'not seen before' mask.

        insert=True (admit) also records the items (L2 'admit' op + L1
        add); insert=False (contains) is read-only and returns PRESENCE
        (the negation), handled by the caller.
        """
        rows = self._norm(items)
        B = len(rows)
        verdict = np.zeros(B, bool)       # True = not present / admitted
        l1_hit = np.zeros(B, bool)
        degraded = np.zeros(B, bool)
        owners = self.owner_shards(rows) if B else np.zeros(0, np.int32)
        # L1 front: hits are duplicates, decided locally -- bit-identical
        # to the healthy path whether or not any shard is down.
        if B:
            l1_hit = self.l1.contains_batch(rows)
            self.stats["l1_hits"] += int(l1_hit.sum())
        for shard in range(self.n_shards):
            idx = np.flatnonzero((owners == shard) & ~l1_hit)
            if len(idx) == 0:
                continue
            shard_rows = [rows[i] for i in idx]
            self._req_counter += 1
            op = "admit" if insert else "contains"
            self.stats["l2_calls"] += 1
            reply = self._call_shard(shard, ShardRequest(
                op=op, items=tuple(shard_rows), req_id=self._req_counter))
            if reply is not None and len(reply.payload) == len(idx):
                ok = reply.payload if insert else ~reply.payload
                verdict[idx] = ok
            else:
                if reply is not None:  # wrong-shape reply: treat as outage
                    self._log("bad_payload", shard, op)
                degraded[idx] = True
                self.stats["degraded_decisions"] += len(idx)
                verdict[idx] = self.policy == "fail_open"
                if insert:
                    # remember what L2 missed: replayed on recovery
                    self._journal_items(shard, shard_rows)
                    if self.policy == "fail_open":
                        self.stats["l1_only_admits"] += len(idx)
            if insert:
                # absorb into the hot-set front regardless of verdict --
                # the next occurrence is an L1 hit, shard up or down
                self.l1.add_batch(shard_rows)
        self.last_info = {"owner": owners, "l1_hit": l1_hit,
                          "degraded": degraded}
        return verdict

    def admit_batch(self, items) -> np.ndarray:
        """(B,) bool: True where the item was newly admitted (not seen
        before), decided hierarchically (L1 -> owner shard) in arrival
        order, under deadlines/retries/breakers; per-item provenance lands
        in `last_info`."""
        out = self._decide_batch(items, insert=True)
        self.stats["admitted"] += int(out.sum())
        self.stats["rejected"] += int(len(out) - out.sum())
        return out

    def contains_batch(self, items) -> np.ndarray:
        """(B,) bool presence (read-only; no L1/L2 inserts, no journal).
        Degraded shards answer per policy: fail_open -> absent (the caller
        admits), fail_closed -> present (the caller rejects)."""
        return ~self._decide_batch(items, insert=False)
