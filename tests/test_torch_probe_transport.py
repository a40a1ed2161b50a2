"""Port `DeviceShardedBloom` and its three probe transports == the reference.

Mirrors `tests/test_probe_transport.py` and the Bloom cases of
`tests/test_distributed_hash.py`. The port runs on D logical shards of the
CPU; the reference `DeviceShardedBloom` runs on its one-device
`data_mesh()` (one module-scoped filter per transport, so JAX traces a
few shapes only) and the reference host `BloomFilter` gives the words.
Every comparison is exact equality.
"""
import warnings

import numpy as np
import pytest
import torch

from _torch_port import (bloom_bytes, cpu_mesh, load_bloom_bytes, rng, u32,
                         words_to_bytes)
from repro.data import BloomFilter as JBloom
from repro.data import ExactDedup as JExact
from repro.hash import DeviceShardedBloom as JDSB
from repro.hash import FilterShardBackend as JBackend
from repro.hash import Hasher as JHasher
from repro.hash import HashSpec as JSpec
from repro.hash import ProbeBucketOverflow as JOverflow
from repro.hash import ProbeTransport as JTransport
from repro.hash import ShardRequest as JRequest
from repro.hash.sharding import reduce_range
from repro.parallel.sharding import data_mesh as jmesh
from repro_torch.data import ExactDedup as TExact
from repro_torch.hash import DeviceShardedBloom as TDSB
from repro_torch.hash import FilterShardBackend as TBackend
from repro_torch.hash import ProbeBucketOverflow, ProbeTransport
from repro_torch.hash import ShardRequest as TRequest
from repro_torch.kernels import ops as tops

TRANSPORTS = ["host", "all_gather", "routed"]
FAMILIES = ["multilinear", "gf_multilinear"]
SHARDS = [1, 2, 4, 8]
N_ITEMS = 2000  # m = 28,755 bits, k = 9


def _rows(seed, n, longest=15):
    """n ragged rows of 1..longest tokens, the last one `longest` long
    (every batch stages at the same width)."""
    g = rng(seed)
    rows = [u32(g, int(L)) for L in g.integers(1, longest, n - 1)]
    return rows + [u32(g, longest)]


A = _rows(0x9702, 32)
# B: 12 new rows, 8 repeats of A, 4 in-batch duplicates, 8 more new rows
_new = _rows(0x9703, 20)
B = _new[:12] + A[:8] + _new[:4] + _new[12:]


def _workload(f):
    """add A; contains B; check_and_add B -> (bits after A, contains,
    admitted, final bits)."""
    f.add_batch(A)
    after_a = bloom_bytes(f)
    present = np.asarray(f.contains_batch(B))
    admitted = np.asarray(f.check_and_add_batch(B))
    return after_a, present, admitted, bloom_bytes(f)


@pytest.fixture(scope="module")
def reference():
    """Per transport: the reference filter's workload results (family
    multilinear). The reference's carry-less DeviceShardedBloom traces take
    5-20 s each here, so the carry-less family is held against the
    reference host BloomFilter (`host_words`) alone -- the reference's own
    tests pin its transports to that filter."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _workload(JDSB(n_items=N_ITEMS, fp_rate=1e-3,
                                         probe_transport=kind))
        return cache[kind]
    return get


@pytest.fixture(scope="module")
def host_words():
    """Per family: the reference host BloomFilter's pre-batch presence of B
    after A and its bytes after A and after A + B."""
    cache = {}

    def get(family):
        if family not in cache:
            bf = JBloom(n_items=N_ITEMS, fp_rate=1e-3, family=family)
            bf.add_batch(A)
            after_a = words_to_bytes(bf.bits, bf.m)
            present = bf.contains_batch(B)
            bf.add_batch(B)
            cache[family] = after_a, present, words_to_bytes(bf.bits, bf.m)
        return cache[family]
    return get


# ---------------------------------------------------------------------------
# the spec object
# ---------------------------------------------------------------------------

def test_probe_transport_validation():
    assert ProbeTransport.of("routed").kind == "routed"
    pt = ProbeTransport("all_gather", capacity_factor=2.0)
    assert ProbeTransport.of(pt) is pt
    for bad, match in (({"kind": "carrier_pigeon"}, "kind"),
                       ({"on_overflow": "shrug"}, "on_overflow"),
                       ({"capacity_factor": 0.0}, "capacity_factor"),
                       ({"capacity_slack": -1}, "capacity_slack")):
        with pytest.raises(ValueError, match=match):
            ProbeTransport(**bad)
        with pytest.raises(ValueError, match=match):
            JTransport(**bad)
    with pytest.raises(TypeError):
        ProbeTransport.of(7)


@pytest.mark.parametrize("factor,slack", [(1.25, 16), (1e-9, 0), (0.5, 0),
                                          (0.02, 3), (2.0, 16)])
def test_probe_transport_capacity_matches_reference(factor, slack):
    t = ProbeTransport("routed", capacity_factor=factor, capacity_slack=slack)
    j = JTransport("routed", capacity_factor=factor, capacity_slack=slack)
    for n in (1, 7, 100, 4096, 147456, 65536 * 9):
        for D in (1, 2, 3, 4, 8):
            assert t.capacity(n, D) == j.capacity(n, D), (n, D)
    assert ProbeTransport().capacity(7, 1) == 7  # D = 1: overflow-free


# ---------------------------------------------------------------------------
# every transport x D x family == the reference, verdicts and bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", TRANSPORTS)
def test_transport_matches_reference(kind, family, D, reference, host_words):
    f = TDSB(n_items=N_ITEMS, fp_rate=1e-3, probe_transport=kind,
             family=family, mesh=cpu_mesh(D))
    assert (f.m, f.k, f.n_shards) == (28755, 9, D)
    assert f.m_local == -(-f.m // D)
    got = _workload(f)
    if family == "multilinear":
        for a, b in zip(got, reference(kind)):
            np.testing.assert_array_equal(a, b)
    after_a, present, final = host_words(family)
    np.testing.assert_array_equal(got[0], after_a)
    np.testing.assert_array_equal(got[1], present)
    np.testing.assert_array_equal(got[2], ~present)
    np.testing.assert_array_equal(got[3], final)
    assert f.contains_batch(A).all() and f.contains_batch(B).all()
    words = f.words().numpy().view(np.uint64)
    assert words.shape == (-(-f.m // 64),)
    np.testing.assert_array_equal(words_to_bytes(words, f.m), final)
    # one engine launch a shard per call
    before = tops.launch_count()
    f.check_and_add_batch(B)
    assert tops.launch_count() == before + D
    assert f.stats == {"overflow_fallbacks": 0}
    assert all(int(b[f.m_local]) == 1 for b in f._bits)  # drop slots


@pytest.mark.parametrize("D", [1, 4])
def test_state_crosses_through_global_bytes(D, reference):
    """A port filter started from the reference filter's bytes decides the
    next batch as the reference did."""
    after_a, present, admitted, final = reference("routed")
    f = TDSB(n_items=N_ITEMS, fp_rate=1e-3, mesh=cpu_mesh(D))
    load_bloom_bytes(f, after_a)
    np.testing.assert_array_equal(bloom_bytes(f), after_a)
    np.testing.assert_array_equal(f.contains_batch(B), present)
    np.testing.assert_array_equal(f.check_and_add_batch(B), admitted)
    np.testing.assert_array_equal(bloom_bytes(f), final)


# ---------------------------------------------------------------------------
# sentinel rows, empty batches, owner_shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 4])
def test_routed_sentinel_rows_owned_by_no_shard(D):
    """Staged padding rows carry the -1 probe sentinel: they light NO bits
    through the routed exchange (an all-invalid add leaves the filter empty
    and raises no overflow) and read back as 'present' in the raw verdict
    vector (sliced off by the host wrapper)."""
    f = TDSB(n_items=128, fp_rate=1e-2, probe_transport="routed",
             mesh=cpu_mesh(D))
    st = f._stage(A[:5])
    assert st.B == 5 and st.Bp == 8  # D * pow2(ceil(5 / D))
    f._add_staged(st._replace(valid=[torch.zeros_like(v) for v in st.valid]))
    assert not f._pending[0][0].any()
    assert not f.bits.any()
    out, recv_g = f._verdict_staged(st, insert=False)
    assert out[st.B:st.Bp].all() and not out[st.Bp:].any()  # flags clear
    assert len(recv_g) == D and all(g.shape[0] == D for g in recv_g)


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_empty_batches(kind):
    f = TDSB(n_items=64, probe_transport=kind, mesh=cpu_mesh(2))
    before = tops.launch_count()
    f.add_batch([])
    assert f.contains_batch([]).shape == (0,)
    assert f.check_and_add_batch([]).shape == (0,)
    assert tops.launch_count() == before and not f.bits.any()
    f.add(A[0])
    assert A[0] in f and A[1] not in f


@pytest.mark.parametrize("D", [1, 3, 4])
def test_owner_shards(D):
    f = TDSB(n_items=N_ITEMS, mesh=cpu_mesh(D))
    h = JHasher.from_spec(JSpec(family="multilinear", n_hashes=f.k, out_bits=64,
                                variable_length=True, seed=0xB100))
    h32 = (h.hash_batch(B, backend="host")[:, 0] >> np.uint64(32)).astype(
        np.uint32)
    got = f.owner_shards(B)
    np.testing.assert_array_equal(got, reduce_range(h32, D))
    if D == 1:
        np.testing.assert_array_equal(got, JDSB(n_items=N_ITEMS).owner_shards(B))


def test_m_at_the_int32_limit_is_refused():
    with pytest.raises(ValueError, match="int32"):
        TDSB(n_items=2 * 10**8, fp_rate=1e-3, mesh=cpu_mesh(1))


# ---------------------------------------------------------------------------
# overflow: fallback and the error policy
# ---------------------------------------------------------------------------

TINY = dict(capacity_factor=1e-9, capacity_slack=0)


def _overflow_run(f):
    """add A (deferred), contains B (settles the add, then overflows)."""
    f.add_batch(A)
    present = np.asarray(f.contains_batch(B))
    return present, bloom_bytes(f), dict(f.stats)


@pytest.fixture(scope="module")
def reference_overflow():
    return _overflow_run(JDSB(n_items=N_ITEMS,
                              probe_transport=JTransport("routed", **TINY)))


@pytest.mark.parametrize("D", [1, 4])
def test_overflow_fallback_is_bit_identical(D, reference_overflow, host_words):
    f = TDSB(n_items=N_ITEMS, probe_transport=ProbeTransport("routed", **TINY),
             mesh=cpu_mesh(D))
    got = _overflow_run(f)
    after_a, present, final = host_words("multilinear")
    np.testing.assert_array_equal(got[0], present)
    np.testing.assert_array_equal(got[1], after_a)
    if D == 1:
        np.testing.assert_array_equal(got[0], reference_overflow[0])
        np.testing.assert_array_equal(got[1], reference_overflow[1])
        assert got[2] == reference_overflow[2]
    assert got[2]["overflow_fallbacks"] == 2  # the settled add, contains
    np.testing.assert_array_equal(f.check_and_add_batch(B), ~present)
    np.testing.assert_array_equal(bloom_bytes(f), final)
    assert f.stats["overflow_fallbacks"] == 3


@pytest.fixture(scope="module")
def reference_error():
    f = JDSB(n_items=N_ITEMS, probe_transport=JTransport(
        "routed", on_overflow="error", **TINY))
    with pytest.raises(JOverflow, match="capacity"):
        f.add_batch(A)   # deferred: the flag settles in the next call
        f.contains_batch(A)
    return bloom_bytes(f), dict(f.stats)


@pytest.mark.parametrize("D", [1, 4])
def test_overflow_error_policy_raises_after_repair(D, reference_error,
                                                   host_words):
    f = TDSB(n_items=N_ITEMS, mesh=cpu_mesh(D), probe_transport=ProbeTransport(
        "routed", on_overflow="error", **TINY))
    f.add_batch(A)
    assert f._pending  # deferred, no read yet
    with pytest.raises(ProbeBucketOverflow, match="capacity"):
        f.contains_batch(A)
    after_a, _, _ = host_words("multilinear")
    np.testing.assert_array_equal(bloom_bytes(f), after_a)  # repaired
    np.testing.assert_array_equal(bloom_bytes(f), reference_error[0])
    assert f.stats == reference_error[1] == {"overflow_fallbacks": 1}
    # a verdict call that overflows raises before touching the state
    with pytest.raises(ProbeBucketOverflow, match="unchanged"):
        f.check_and_add_batch(B)
    np.testing.assert_array_equal(bloom_bytes(f), after_a)


def test_settle_every_bounds_the_deferred_adds():
    f = TDSB(n_items=N_ITEMS, mesh=cpu_mesh(2),
             probe_transport=ProbeTransport("routed", **TINY))
    for i in range(f._settle_every - 1):
        f.add_batch(A[i:i + 4])
    assert len(f._pending) == f._settle_every - 1
    assert f.stats["overflow_fallbacks"] == 0
    f.add_batch(A[8:12])  # the 8th pending add settles them all
    assert not f._pending and f.stats["overflow_fallbacks"] == 8
    assert f.contains_batch(A[:12]).all()


# ---------------------------------------------------------------------------
# the in_graph_mod= deprecation shim
# ---------------------------------------------------------------------------

def _one_warning(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)
           and "repro_torch.hash" in str(w.message)]
    assert len(dep) == 1, [str(w.message) for w in rec]
    return out


@pytest.mark.parametrize("legacy,kind", [(True, "all_gather"), (False, "host")])
def test_in_graph_mod_shim(legacy, kind, host_words):
    old = _one_warning(lambda: TDSB(n_items=N_ITEMS, in_graph_mod=legacy,
                                    mesh=cpu_mesh(2)))
    assert old.transport.kind == kind and old.in_graph_mod is legacy
    new = TDSB(n_items=N_ITEMS, probe_transport=kind, mesh=cpu_mesh(2))
    for f in (old, new):
        f.add_batch(A)
    np.testing.assert_array_equal(bloom_bytes(old), bloom_bytes(new))
    np.testing.assert_array_equal(old.check_and_add_batch(B),
                                  new.check_and_add_batch(B))
    np.testing.assert_array_equal(bloom_bytes(old), host_words("multilinear")[2])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        TDSB(n_items=64, probe_transport="routed", mesh=cpu_mesh(1))
        TDSB(n_items=64, probe_transport=ProbeTransport("all_gather"),
             mesh=cpu_mesh(1))
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]


# ---------------------------------------------------------------------------
# consumers: the service backend adapter and ExactDedup's Bloom authority
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2])
def test_filter_shard_backend_replays_by_req_id(D):
    """Replies (payload and fingerprint) equal the reference backend's over
    its host BloomFilter (these rows hold no in-batch duplicate, so the
    batched and the arrival-order contracts agree); a retried req_id gets
    the cached reply without touching the filter."""
    t = TBackend(TDSB(n_items=4096, mesh=cpu_mesh(D)))
    j = JBackend(JBloom(n_items=4096))
    rows = tuple(A[:20])
    for op, rid in (("admit", 1), ("admit", 2), ("contains", 3), ("ping", 0),
                    ("add", 4)):
        rt = t.serve(TRequest(op=op, items=rows if op != "ping" else (),
                              req_id=rid))
        rj = j.serve(JRequest(op=op, items=rows if op != "ping" else (),
                              req_id=rid))
        np.testing.assert_array_equal(rt.payload, rj.payload)
        assert rt.fingerprint == rj.fingerprint and rt.verify()
    again = t.serve(TRequest(op="admit", items=rows, req_id=1))
    assert again.payload.all() and t.calls["replayed"] == 1
    assert t.calls == {**j.calls, "replayed": 1}
    for backend, req in ((t, TRequest), (j, JRequest)):  # as the reference
        with pytest.raises(KeyError):
            backend.serve(req(op="delete", items=rows, req_id=9))


@pytest.mark.parametrize("D", [1, 4])
def test_exact_dedup_approx_mode(D):
    g = rng(0xE6)
    docs = [u32(g, int(n)) for n in g.integers(1, 15, 40)] + [u32(g, 15)]
    t = TExact(mesh=cpu_mesh(D), approx_items=4096, probe_transport="routed")
    j = JExact(mesh=jmesh(), approx_items=4096, probe_transport="routed")
    assert t._bloom.transport.kind == "routed" and t._bloom.n_shards == D
    assert (t._bloom.m, t._bloom.k) == (j._bloom.m, j._bloom.k)
    first = t.add_documents(docs)
    np.testing.assert_array_equal(first, j.add_documents(docs))
    np.testing.assert_array_equal(first, TExact(device="cpu").add_documents(docs))
    assert not t.add_documents(docs).any()
    np.testing.assert_array_equal(bloom_bytes(t._bloom), bloom_bytes(j._bloom))
