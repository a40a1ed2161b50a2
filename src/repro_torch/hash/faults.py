"""`FaultPlan` -- seeded, deterministic fault injection for the admission
transport.

The port of `repro.hash.faults` (numpy and Python; a plan gives the same
decisions in both packages). Every robustness claim in `hash.service` is
asserted UNDER injected faults, not just on the happy path, and the
injection itself is a pure function of the plan: the fault decision for
the i-th call to shard s depends only on (plan seed, s, i) plus the
scheduled events -- never on wall-clock time, thread interleaving, or the
other shards' traffic. Two runs of the same (plan, workload) therefore
produce bit-identical retry / backoff / breaker-transition logs, which is
exactly what the chaos suite replays and compares.

Fault kinds (`FaultKinds`):

- ``timeout``  -- the reply never arrives; the caller burns its full
                  per-attempt deadline, then `DeadlineExceeded`.
- ``drop``     -- the request REACHES the backend (side effects happen!)
                  but the reply is lost: `ShardUnavailable` after the
                  backend executed. This is the at-least-once case the
                  service's idempotent `req_id` reply cache exists for.
- ``latency``  -- a latency spike; the reply arrives late. If the spike
                  exceeds the deadline it degenerates to a timeout.
- ``corrupt``  -- the reply payload is bit-flipped in flight (fingerprint
                  left stale), exercising the integrity check.
- ``crash``    -- the shard is down for a WINDOW of its call sequence:
                  every attempt in [at, until) fails `ShardUnavailable`
                  fast. Health probes advance the sequence, so a crashed
                  shard recovers after enough probe attempts -- which makes
                  "kill shard 2 for its next 6 calls" a complete,
                  deterministic outage-and-recovery scenario.

Scheduled `FaultEvent`s compose with seeded random faults (per-call
probabilities drawn from a Philox stream keyed on (seed, shard, seq)), so a
plan can be a precise script, background noise, or both.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .service import (DeadlineExceeded, ShardReply, ShardUnavailable,
                      VirtualClock, philox_for)

FaultKinds = ("timeout", "drop", "latency", "corrupt", "crash")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: `kind` applied to `shard` (None = every shard)
    for the per-shard call-sequence window [at, until) -- `until=None`
    means the single call `at` (or, for ``crash``, until forever)."""

    kind: str
    shard: int | None = None
    at: int = 0
    until: int | None = None
    latency_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FaultKinds:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FaultKinds}")

    def active(self, shard: int, seq: int) -> bool:
        if self.shard is not None and self.shard != shard:
            return False
        if self.until is None:
            return seq >= self.at if self.kind == "crash" else seq == self.at
        return self.at <= seq < self.until


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What happens to one transport call: an injected fault kind (or
    'ok') plus the simulated latency the virtual clock advances by."""

    kind: str
    latency_s: float = 0.0


class FaultPlan:
    """Deterministic schedule of transport faults.

    events:     explicit `FaultEvent` script (precedence over random
                faults; first matching event wins).
    p_timeout / p_drop / p_corrupt / p_latency:
                per-call probabilities of seeded random faults, drawn in a
                FIXED order from Philox(seed, shard, seq) so the decision
                for call (shard, seq) never depends on other traffic.
    base_latency_s / spike_latency_s:
                healthy per-call latency and the added spike magnitude.
    """

    def __init__(self, seed: int, events=(), *, p_timeout: float = 0.0,
                 p_drop: float = 0.0, p_corrupt: float = 0.0,
                 p_latency: float = 0.0, base_latency_s: float = 0.0,
                 spike_latency_s: float = 0.05):
        self.seed = int(seed)
        self.events = tuple(events)
        self.p_timeout = float(p_timeout)
        self.p_drop = float(p_drop)
        self.p_corrupt = float(p_corrupt)
        self.p_latency = float(p_latency)
        self.base_latency_s = float(base_latency_s)
        self.spike_latency_s = float(spike_latency_s)

    def _rng(self, shard: int, seq: int, salt: int = 0) -> np.random.Generator:
        return philox_for(self.seed, 0xFA017 + salt, shard, seq)

    def decide(self, shard: int, seq: int) -> FaultDecision:
        """The fault decision for the seq-th call to `shard` -- pure."""
        for ev in self.events:
            if ev.active(shard, seq):
                lat = ev.latency_s or (self.spike_latency_s
                                       if ev.kind == "latency" else
                                       self.base_latency_s)
                return FaultDecision(ev.kind, lat)
        # seeded random faults: one uniform draw per kind, fixed order, so
        # adding a new kind never reshuffles earlier plans' decisions
        u = self._rng(shard, seq).random(4)
        if u[0] < self.p_timeout:
            return FaultDecision("timeout", self.base_latency_s)
        if u[1] < self.p_drop:
            return FaultDecision("drop", self.base_latency_s)
        if u[2] < self.p_corrupt:
            return FaultDecision("corrupt", self.base_latency_s)
        if u[3] < self.p_latency:
            return FaultDecision("latency",
                                 self.base_latency_s + self.spike_latency_s)
        return FaultDecision("ok", self.base_latency_s)

    def corrupt_reply(self, reply: ShardReply, shard: int,
                      seq: int) -> ShardReply:
        """Deterministically damage a reply IN FLIGHT: flip one payload
        byte (fingerprint left stale => integrity check must catch it);
        empty payloads get a stale fingerprint instead."""
        raw = bytearray(reply.payload.tobytes())
        if not raw:
            return ShardReply(payload=reply.payload,
                              fingerprint=reply.fingerprint ^ 1)
        k = int(self._rng(shard, seq, salt=1).integers(0, len(raw)))
        raw[k] ^= 0xFF
        payload = np.frombuffer(bytes(raw), dtype=reply.payload.dtype
                                ).reshape(reply.payload.shape)
        return ShardReply(payload=payload, fingerprint=reply.fingerprint)


class FaultyTransport:
    """Wrap any transport with a `FaultPlan` + `VirtualClock`.

    Latency is SIMULATED: the clock advances by the decided latency (capped
    at the caller's deadline) and timeouts raise `DeadlineExceeded` without
    any real sleeping -- a thousand-fault chaos run takes milliseconds of
    wall time and is bit-reproducible.
    """

    def __init__(self, inner, plan: FaultPlan, clock: VirtualClock):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        self.seq = [0] * int(inner.n_shards)
        #: (shard, seq, decided kind) per call -- the injection audit trail
        self.injected: list[tuple[int, int, str]] = []

    @property
    def n_shards(self) -> int:
        return self.inner.n_shards

    def call(self, shard: int, request, deadline_s: float | None = None):
        seq = self.seq[shard]
        self.seq[shard] = seq + 1
        d = self.plan.decide(shard, seq)
        self.injected.append((shard, seq, d.kind))
        if d.kind == "crash":
            # connection refused: fails fast, no deadline burned
            self.clock.sleep(self.plan.base_latency_s)
            raise ShardUnavailable(f"shard {shard} crashed (call {seq})")
        if d.kind == "timeout":
            if deadline_s is not None:
                self.clock.sleep(deadline_s)
            raise DeadlineExceeded(f"shard {shard}: no reply (call {seq})")
        if deadline_s is not None and d.latency_s >= deadline_s:
            # the spike outlives the deadline: the reply is late, the
            # caller has already given up (and the backend DID execute)
            self.inner.call(shard, request, deadline_s)
            self.clock.sleep(deadline_s)
            raise DeadlineExceeded(
                f"shard {shard}: latency {d.latency_s:.3f}s >= deadline")
        self.clock.sleep(d.latency_s)
        reply = self.inner.call(shard, request, deadline_s)
        if d.kind == "drop":
            raise ShardUnavailable(f"shard {shard}: reply dropped (call {seq})")
        if d.kind == "corrupt":
            return self.plan.corrupt_reply(reply, shard, seq)
        return reply
