"""Port admission service (`hash.service`, `hash.faults`) == the reference.

Mirrors `tests/test_admission_service.py` and the non-serve cases of
`tests/test_chaos.py`: the same seeded `FaultPlan` over the same workload
gives identical verdicts, `events`, `stats`, `last_info`, breaker
transitions, injected faults and final filter words in both packages --
over host `BloomFilter` shard backends, and over `DeviceShardedBloom`
backends (the port on 2 logical CPU shards, the reference on its
one-device mesh). Everything runs on the virtual clock.
"""
import numpy as np
import pytest

import repro.hash as J
import repro_torch.hash as T
from _torch_port import bloom_bytes, cpu_mesh, words_to_bytes
from repro.data.pipeline import HashPipeline as JPipe
from repro.data.pipeline import PipelineConfig as JCfg
from repro.parallel.sharding import data_mesh as jmesh
from repro_torch.data.pipeline import HashPipeline as TPipe
from repro_torch.data.pipeline import PipelineConfig as TCfg

N_SHARDS = 4
SEED_MATRIX = [3, 7, 11, 19, 23]


def _items(n, seed=0, lo=3, hi=12):
    g = np.random.default_rng(seed)
    return [g.integers(0, 1000, g.integers(lo, hi), dtype=np.uint32)
            for _ in range(n)]


def _workload(seed, n=96, dup_every=3):
    """Token rows with deliberate duplicates (test_chaos's workload)."""
    g = np.random.default_rng(seed)
    rows = [g.integers(0, 2000, g.integers(3, 14), dtype=np.uint32)
            for _ in range(n)]
    for i in range(dup_every, n, dup_every):
        rows[i] = rows[i - dup_every].copy()
    return rows


def _plan(P, seed, n_shards=N_SHARDS):
    """Scheduled crash window on one shard + background random faults."""
    return P.FaultPlan(
        seed, events=[P.FaultEvent("crash", shard=seed % n_shards, at=0,
                                   until=5)],
        p_timeout=0.05, p_drop=0.05, p_corrupt=0.05, p_latency=0.05)


def _service(P, n_shards=N_SHARDS, n_items=8192, plan=None, mesh=None,
             policy="fail_open", **kw):
    """A service of package P over fresh backends (host BloomFilters, or
    DeviceShardedBloom over `mesh`), optionally under a fault plan."""
    dev = {} if P is J else {"device": "cpu"}
    backends = P.bloom_shard_backends(n_shards, n_items, mesh=mesh, **kw, **dev)
    clock = P.VirtualClock()
    transport = P.InProcessTransport(backends)
    if plan is not None:
        transport = P.FaultyTransport(transport, plan, clock)
    return P.AdmissionService(transport, clock=clock, policy=policy,
                              **dev), backends


def _words(backends):
    return [bloom_bytes(b.filt) if hasattr(b.filt, "m_local")
            else words_to_bytes(b.filt.bits, b.filt.m) for b in backends]


def _same_run(t, j):
    """Two (service, backends, masks, infos) runs agree in every record."""
    (ts, tb, tm, ti), (js, jb, jm, ji) = t, j
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ti, ji):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert ts.events == js.events
    assert ts.stats == js.stats
    assert [b.transitions for b in ts.breakers] == \
        [b.transitions for b in js.breakers]
    assert ts.clock.now() == js.clock.now()
    if hasattr(ts.transport, "injected"):
        assert ts.transport.injected == js.transport.injected
    for a, b in zip(_words(tb), _words(jb)):
        np.testing.assert_array_equal(a, b)
    assert [b.calls for b in tb] == [b.calls for b in jb]


def _drive(P, rows, step=16, reconcile=False, **kw):
    svc, backends = _service(P, **kw)
    masks, infos = [], []
    for i in range(0, len(rows), step):
        masks.append(svc.admit_batch(rows[i:i + step]))
        infos.append({k: v.copy() for k, v in svc.last_info.items()})
    if reconcile:
        masks.append(np.array([svc.reconcile_all(rounds=32)]))
    return svc, backends, masks, infos


# -- clock / retry / breaker / wire format ----------------------------------

def test_clock_backoff_and_jitter_match_reference():
    for P in (T, J):
        c = P.VirtualClock()
        c.sleep(0.5)
        c.sleep(-1.0)
        assert c.now() == 0.5
    kw = dict(base_backoff_s=0.01, multiplier=2.0, max_backoff_s=0.05,
              jitter_frac=0.5)
    tp, jp = T.RetryPolicy(**kw), J.RetryPolicy(**kw)
    for k in range(6):
        for u in (0.0, 0.25, 0.5, 0.999):
            assert tp.backoff_s(k, u) == jp.backoff_s(k, u)
    for args in ((1, 0xBACC0FF, 2, 3), (0xAD417, 0xFA017, 0, 7)):
        assert (T.service.philox_for(*args).random(4).tolist()
                == J.service.philox_for(*args).random(4).tolist())
    with pytest.raises(ValueError):
        T.RetryPolicy(max_attempts=0)


def test_breaker_state_machine_matches_reference():
    logs = []
    for P in (T, J):
        clock = P.VirtualClock()
        br = P.CircuitBreaker(P.BreakerConfig(failure_threshold=3,
                                              reset_timeout_s=1.0), clock)
        br.record_failure(); br.record_failure()  # noqa: E702
        br.record_success()
        for _ in range(3):
            br.record_failure()
        assert br.state == "open" and not br.allow()
        clock.sleep(1.0)
        assert br.allow() and br.state == "half_open"
        br.record_failure()
        clock.sleep(1.0)
        br.allow()
        br.record_success()
        assert br.state == "closed"
        logs.append(br.transitions)
    assert logs[0] == logs[1]
    assert [(f, t) for _, f, t in logs[0]] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "open"),
        ("open", "half_open"), ("half_open", "closed")]


def test_reply_fingerprint_and_corruption_match_reference():
    payload = np.array([True, False, True, True, False])
    t, j = T.ShardReply.for_payload(payload), J.ShardReply.for_payload(payload)
    assert t.fingerprint == j.fingerprint and t.verify()
    for seq in range(4):
        tc = T.FaultPlan(0).corrupt_reply(t, 1, seq)
        jc = J.FaultPlan(0).corrupt_reply(j, 1, seq)
        np.testing.assert_array_equal(tc.payload, jc.payload)
        assert not tc.verify() and tc.fingerprint == jc.fingerprint
    empty = T.ShardReply.for_payload(np.zeros(0, bool))
    assert empty.fingerprint == J.ShardReply.for_payload(np.zeros(0, bool)).fingerprint
    assert not T.FaultPlan(0).corrupt_reply(empty, 0, 0).verify()


def test_fault_plan_decisions_match_reference():
    grid = [(s, q) for s in range(4) for q in range(48)]
    kw = dict(p_timeout=0.2, p_drop=0.2, p_corrupt=0.2, p_latency=0.2,
              base_latency_s=0.001)
    ev = [("timeout", 1, 2, 5), ("crash", 3, 4, None), ("drop", None, 7, None)]
    tp = T.FaultPlan(11, [T.FaultEvent(k, s, a, u) for k, s, a, u in ev], **kw)
    jp = J.FaultPlan(11, [J.FaultEvent(k, s, a, u) for k, s, a, u in ev], **kw)
    got = [tp.decide(s, q) for s, q in grid]
    assert [(d.kind, d.latency_s) for d in got] == \
        [(d.kind, d.latency_s) for d in (jp.decide(s, q) for s, q in grid)]
    assert {d.kind for d in got} >= {"ok", "timeout", "drop", "corrupt",
                                     "latency", "crash"}
    assert [tp.decide(s, q) for s, q in grid] == got  # pure
    one = T.FaultEvent("drop", at=3)
    assert one.active(0, 3) and not one.active(0, 4)
    with pytest.raises(ValueError):
        T.FaultEvent("meteor")


# -- healthy path --------------------------------------------------------------

def test_healthy_service_matches_reference():
    items = _items(40, seed=1)
    runs = [_drive(P, items + items[:10] + items, step=25) for P in (T, J)]
    _same_run(*runs)
    svc = runs[0][0]
    assert svc.stats["l1_hits"] > 0 and svc.stats["rejected"] == 50
    np.testing.assert_array_equal(svc.owner_shards(items),
                                  runs[1][0].owner_shards(items))
    # contains is read-only in both
    fresh = _items(8, seed=3)
    for P, (s, b, _, _) in zip((T, J), runs):
        before = _words(b)
        assert not s.contains_batch(fresh).any()
        for a, c in zip(before, _words(b)):
            np.testing.assert_array_equal(a, c)


def test_config_validation():
    with pytest.raises(ValueError):
        T.AdmissionService(T.InProcessTransport([]), device="cpu")
    backends = T.bloom_shard_backends(1, 64, device="cpu")
    with pytest.raises(ValueError):
        T.AdmissionService(T.InProcessTransport(backends), policy="shrug",
                           device="cpu")


# -- faults: retry / idempotency / integrity / degradation -------------------

@pytest.mark.parametrize("kind", ["corrupt", "drop", "timeout", "latency"])
def test_single_fault_kinds_match_reference(kind):
    items = _items(12, seed=4)
    runs = []
    for P in (T, J):
        plan = P.FaultPlan(5, events=[P.FaultEvent(kind, shard=s, at=0,
                                                   latency_s=0.2)
                                      for s in range(N_SHARDS)])
        runs.append(_drive(P, items, step=12, plan=plan))
    _same_run(*runs)
    assert runs[0][2][0].all()  # retries got the original verdicts


@pytest.mark.parametrize("policy", ["fail_open", "fail_closed"])
def test_outage_policies_and_breaker_match_reference(policy):
    rows = _items(60, seed=5) + _items(60, seed=6)
    runs = []
    for P in (T, J):
        plan = P.FaultPlan(8, events=[P.FaultEvent("crash", shard=0, at=0)])
        runs.append(_drive(P, rows, step=60, plan=plan, policy=policy))
    _same_run(*runs)
    svc = runs[0][0]
    assert svc.breakers[0].state == "open" and svc.stats["fast_fails"] >= 1
    assert (svc.stats["l1_only_admits"] > 0) == (policy == "fail_open")


@pytest.mark.parametrize("seed", SEED_MATRIX)
def test_fault_matrix_matches_reference(seed):
    """test_chaos's plans: identical runs, reconciliation to quiescence,
    and convergence to the fault-free run's filter words."""
    rows = _workload(seed)
    runs = [_drive(P, rows, plan=_plan(P, seed), reconcile=True)
            for P in (T, J)]
    _same_run(*runs)
    assert runs[0][2][-1].all()  # recovered
    healthy = _drive(T, rows)
    for a, b in zip(_words(healthy[1]), _words(runs[0][1])):
        np.testing.assert_array_equal(a, b)
    # the same plan replays identically
    again = _drive(T, rows, plan=_plan(T, seed), reconcile=True)
    _same_run(again, runs[0])


@pytest.mark.parametrize("kind", ["routed", "all_gather"])
def test_service_over_device_sharded_backends(kind):
    """DeviceShardedBloom shard backends (port: 2 logical shards each) under
    a crash window and timeouts: identical records to the reference's, and
    reconcile_all converges to the fault-free words."""
    rows = _workload(11, n=48)
    runs = []
    for P, mesh in ((T, cpu_mesh(2)), (J, jmesh())):
        plan = P.FaultPlan(11, events=[P.FaultEvent("crash", shard=1, at=0,
                                                    until=4)], p_timeout=0.1)
        runs.append(_drive(P, rows, step=24, n_shards=2, n_items=1 << 12,
                           plan=plan, mesh=mesh, probe_transport=kind,
                           reconcile=True))
    _same_run(*runs)
    svc = runs[0][0]
    assert all(isinstance(b.filt, T.DeviceShardedBloom)
               and b.filt.n_shards == 2 and b.filt.transport.kind == kind
               for b in runs[0][1])
    assert svc.stats["reconciled_items"] > 0 and not svc.degraded
    healthy = _drive(T, rows, step=24, n_shards=2, n_items=1 << 12,
                     mesh=cpu_mesh(2), probe_transport=kind)
    for a, b in zip(_words(healthy[1]), _words(runs[0][1])):
        np.testing.assert_array_equal(a, b)


def test_over_bloom_shards():
    """The one-call constructor: DeviceShardedBloom backends over the mesh
    (the router and L1 on its device), or host backends on `device`; the
    two decide alike on distinct items, as the reference's do."""
    items = _items(64, seed=8)
    t = T.AdmissionService.over_bloom_shards(2, 1 << 12, mesh=cpu_mesh(2),
                                             probe_transport="all_gather")
    assert t.router.device.type == "cpu" and t.l1.hasher.device.type == "cpu"
    assert [b.filt.transport.kind for b in t.transport.backends] == \
        ["all_gather"] * 2
    host = T.AdmissionService.over_bloom_shards(2, 1 << 12, device="cpu")
    first = t.admit_batch(items)
    np.testing.assert_array_equal(first, host.admit_batch(items))
    assert first.all() and not t.admit_batch(items).any()
    np.testing.assert_array_equal(
        first, J.AdmissionService.over_bloom_shards(2, 1 << 12).admit_batch(items))


def test_pipeline_dedup_via_admission_service():
    docs = _items(30, seed=10, lo=5, hi=20)
    cfg = dict(seq_len=16, batch_size=2, eval_pct=0, n_shards=1)
    tsvc, _ = _service(T, n_shards=2)
    jsvc, _ = _service(J, n_shards=2)
    t = TPipe(TCfg(**cfg), admission=tsvc, device="cpu")
    j = JPipe(JCfg(**cfg), admission=jsvc)
    routes = t.admit_batch(docs + docs[:5])
    assert routes == j.admit_batch(docs + docs[:5])
    assert routes == TPipe(TCfg(**cfg), device="cpu").admit_batch(docs + docs[:5])
    assert t.stats == j.stats and t.stats["dup"] == 5
    assert tsvc.stats == jsvc.stats and tsvc.stats["rejected"] == 5
    assert t.admit(docs[0]) == j.admit(docs[0]) == "dup"
    # with a mesh as well: the routing hashes shard, the verdicts do not move
    tm = TPipe(TCfg(**cfg), mesh=cpu_mesh(2), admission=_service(T, n_shards=2)[0])
    assert tm.admit_batch(docs + docs[:5]) == routes
