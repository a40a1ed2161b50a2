"""The port's recorder (`repro_torch.tracing`) on the CPU: spans off and on,
their parents, calls and self times, threads, the capacity, and the launch
counters that live in it. The card's counters are in
`tests/test_torch_cuda_tracing.py`."""
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.hash import Hasher, HashSpec
from repro_torch.kernels import gf_multihash as gfmh
from repro_torch.kernels import gf_multilinear as gfk
from repro_torch.kernels import multihash as mhk
from repro_torch.kernels import multilinear as mlk
from repro_torch.kernels import ops
from repro_torch.parallel import local_world
from repro_torch.parallel.sharding import Mesh

M = 1_437_758_756  # the README's Bloom filter of 10**8 items at 1e-3


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.enable(0)  # empties the last test's recording
    tracing.disable()
    yield
    tracing.disable()


def _hasher(family="multilinear"):
    spec = HashSpec(family=family, n_hashes=3, out_bits=64, variable_length=True,
                    seed=0x7ACE)
    return Hasher.from_spec(spec, max_len=16, device="cpu")


def _batch():
    g = np.random.default_rng(5)
    toks = torch.from_numpy(g.integers(0, 2**31, (4, 16)).astype(np.int32))
    return toks, torch.tensor([3, 5, 16, 0], dtype=torch.int32)


#: each tensor surface of the Hasher, and hash_batch (numpy in, no hasher span)
SURFACES = {
    "probe_indices": lambda h, t, n: h.probe_indices(t, M, n),
    "__call__": lambda h, t, n: h(t, n),
    "shard_ids": lambda h, t, n: h.shard_ids(t, 7, n),
    "bit_planes": lambda h, t, n: h.bit_planes(t, n),
    "hash_batch": lambda h, t, n: h.hash_batch(t.numpy().view(np.uint32)),
}


def _boom():
    raise AssertionError("the clock was read with tracing off")


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_off_records_nothing_and_reads_no_clock(monkeypatch, surface):
    h, (toks, lens) = _hasher(), _batch()
    monkeypatch.setattr(tracing, "clock", _boom)
    d0 = ops.launch_count()
    SURFACES[surface](h, toks, lens)
    snap = tracing.snapshot()
    assert snap["spans"] == []
    assert ops.launch_count() == d0 + 1  # launch counters count when off
    assert snap["counters"]["engine.slot_bytes"] == 0


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_a_call_is_one_tree_of_spans(surface):
    h, (toks, lens) = _hasher(), _batch()
    tracing.enable(16)
    for _ in range(2):
        SURFACES[surface](h, toks, lens)
    tracing.disable()
    spans = tracing.snapshot()["spans"]
    # the CPU runs the plain version: no C launcher, so no launch.c
    names = (["launch.multihash"] if surface == "hash_batch"
             else ["hasher.hash_slots", "launch.multihash"])
    assert [s.name for s in spans] == names * 2
    for call in (spans[:len(names)], spans[len(names):]):
        root = call[0]
        assert root.parent == -1 and root.call == root.id
        for parent, child in zip(call, call[1:]):
            assert child.parent == parent.id and child.call == root.id
            assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(tracing, "clock", lambda: next(it))


@pytest.mark.parametrize("case", ["chain", "siblings", "two_calls"])
def test_parents_calls_and_self_times(monkeypatch, case):
    """Spans opened and closed in a known order on a clock that ticks in
    known steps: parent, call id and self time come out exactly."""
    ev = {  # (op, name) in order; each op reads the clock once
        "chain": [("b", "a"), ("b", "b"), ("b", "c"), ("e", "c"), ("e", "b"),
                  ("e", "a")],
        "siblings": [("b", "a"), ("b", "b"), ("e", "b"), ("b", "c"), ("e", "c"),
                     ("e", "a")],
        "two_calls": [("b", "a"), ("b", "b"), ("e", "b"), ("e", "a"), ("b", "a"),
                      ("e", "a")],
    }[case]
    ticks = [0, 10, 30, 60, 100, 150]  # gaps 10, 20, 30, 40, 50
    _fake_clock(monkeypatch, ticks)
    tracing.enable(8)
    open_ = []
    for op, name in ev:
        if op == "b":
            open_.append(tracing.begin(name))
        else:
            tracing.end(open_.pop())
    tracing.disable()
    snap = tracing.snapshot()
    got = [(s.name, s.start_ns, s.end_ns, s.parent, s.call) for s in snap["spans"]]
    want = {
        "chain": [("a", 0, 150, -1, 0), ("b", 10, 100, 0, 0), ("c", 30, 60, 1, 0)],
        "siblings": [("a", 0, 150, -1, 0), ("b", 10, 30, 0, 0), ("c", 60, 100, 0, 0)],
        "two_calls": [("a", 0, 60, -1, 0), ("b", 10, 30, 0, 0), ("a", 100, 150, -1, 2)],
    }[case]
    assert got == want
    self_ns = {n: t["self_ns"] for n, t in tracing.totals(snap).items()}
    assert self_ns == {
        "chain": {"a": 150 - 90, "b": 90 - 30, "c": 30},
        "siblings": {"a": 150 - 20 - 40, "b": 20, "c": 40},
        "two_calls": {"a": 60 - 20 + 50, "b": 20},
    }[case]


def test_an_error_inside_a_span_closes_it():
    h, (toks, _) = _hasher(), _batch()
    tracing.enable(8)
    with pytest.raises(ValueError, match="capacity"):
        h(torch.zeros((2, 4096), dtype=torch.int32))
    h(toks)
    tracing.disable()
    spans = tracing.snapshot()["spans"]
    assert [s.name for s in spans] == ["hasher.hash_slots", "hasher.hash_slots",
                                       "launch.multihash"]
    assert spans[0].end_ns is not None
    assert spans[1].parent == -1 and spans[1].call == spans[1].id


def test_threads_of_a_world_never_parent_each_others_spans():
    """Two ranks of a threaded world hash at the same time, each inside
    spans of its own: every parent and call lies in the span's own thread,
    and the ranks' calls overlap in time."""
    h, (toks, lens) = _hasher(), _batch()
    gate = threading.Barrier(2, timeout=60)

    def rank(r):
        for _ in range(20):
            gate.wait()
            sp = tracing.begin(f"rank{r}")
            h.probe_indices(toks, M, lens)
            gate.wait()
            tracing.end(sp)

    tracing.enable(1024)
    local_world.run(rank, Mesh((torch.device("cpu"),) * 2))
    tracing.disable()
    spans = {s.id: s for s in tracing.snapshot()["spans"]}
    assert len(spans) == 2 * 20 * 3
    assert len({s.thread for s in spans.values()}) == 2
    for s in spans.values():
        root = spans[s.call]
        assert root.thread == s.thread and root.name.startswith("rank")
        if s.parent != -1:
            assert spans[s.parent].thread == s.thread
    roots = sorted((s.start_ns, s.end_ns, s.thread) for s in spans.values()
                   if s.parent == -1)
    assert any(a[2] != b[2] and b[0] < a[1] for a, b in zip(roots, roots[1:]))


@pytest.mark.parametrize("capacity,spans", [(0, 3), (1, 1), (1, 4), (5, 5), (5, 12)])
def test_spans_past_capacity_are_counted_as_dropped(capacity, spans):
    tracing.enable(capacity)
    for i in range(spans):
        tracing.end(tracing.begin(f"s{i}"))
    tracing.disable()
    snap = tracing.snapshot()
    want = [f"s{i}" for i in range(min(capacity, spans))]
    assert [s.name for s in snap["spans"]] == want
    assert snap["counters"]["tracing.dropped"] == max(0, spans - capacity)
    tracing.enable(capacity)
    assert tracing.snapshot()["counters"]["tracing.dropped"] == 0


LAUNCH_COUNTERS = {"launch.multihash": mhk, "launch.gf_multihash": gfmh,
                   "launch.multilinear": mlk, "launch.gf_multilinear": gfk}


@pytest.mark.parametrize("name", sorted(LAUNCH_COUNTERS))
@pytest.mark.parametrize("tracing_on", [False, True])
def test_kernel_launch_counts_keep_their_meaning(name, tracing_on):
    """Each kernel module's count is its named counter in the tracer:
    `reset_count()` zeroes it alone, the tracer's `enable`/`reset` leave it,
    and a snapshot reports it."""
    mod = LAUNCH_COUNTERS[name]
    assert mod._LAUNCHES is tracing.counter(name)
    if tracing_on:
        tracing.enable(4)
    others = {n: m.launch_count() for n, m in LAUNCH_COUNTERS.items() if n != name}
    mod.reset_count()
    assert mod.launch_count() == 0
    mod._LAUNCHES.n += 3  # what three launches on a card add
    tracing.reset()
    assert mod.launch_count() == 3
    assert tracing.snapshot()["counters"][name] == 3
    mod.reset_count()
    assert mod.launch_count() == 0
    assert others == {n: m.launch_count() for n, m in LAUNCH_COUNTERS.items()
                      if n != name}


@pytest.mark.parametrize("tracing_on", [False, True])
def test_dispatch_count_counts_every_device(tracing_on):
    """`ops.launch_count()` (`launch.dispatch`) counts each engine dispatch,
    on the CPU too, whether tracing is on or off; the CPU's plain version
    adds nothing to the card's launch counts or slot bytes."""
    (toks, lens), h = _batch(), _hasher("gf_multilinear")
    if tracing_on:
        tracing.enable(16)
    d0, k0 = ops.launch_count(), (mhk.launch_count(), gfmh.launch_count())
    for _ in range(3):
        h.probe_indices(toks, M, lens)
    tracing.reset()
    assert ops.launch_count() == d0 + 3
    assert tracing.snapshot()["counters"]["launch.dispatch"] == d0 + 3
    assert (mhk.launch_count(), gfmh.launch_count()) == k0
    assert tracing.snapshot()["counters"]["engine.slot_bytes"] == 0
