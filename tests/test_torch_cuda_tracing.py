"""The tracer's counters and spans on the card (`repro_torch.tracing`): the
engine's own lane and live column counts against the kernel's rule
recomputed on the host, the slot bytes, and the `launch.c` spans against
the profiler's CUDA runtime events on one timeline.

Marked `gpu`: each test skips where no CUDA device exists (decided inside
the test). Run on the card with
`PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_tracing.py`.
This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, rng, t32
from repro_torch import tracing
from repro_torch.hash import Hasher, HashSpec
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import multihash as mhk

pytestmark = pytest.mark.gpu

M = 1_437_758_756  # the README's Bloom filter of 10**8 items at 1e-3
SEG = 65536  # rows the engine orders on their own (csrc/engine_tile.cuh EO_SEG)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    tracing.disable()


def engine_columns(codes, W: int, split: int, K: int,
                   ordered: bool = False) -> tuple:
    """(lane, live) columns of one engine call by the kernel's rule: in each
    split [cs, ce) each warp of 32 rows hashes 32 lanes up to the largest
    kend of its rows, and a row's live columns are its tokens and sentinel
    (`end`) inside the split; a pass of at most 9 functions counts once. A
    warp's rows are 32 consecutive rows (`chip_smoke.py::lane_work`), or,
    where the call runs its rows in length order (`ordered`), 32
    consecutive places of the rows sorted by kend, longest first, in each
    segment of `SEG` rows."""
    codes = np.asarray(codes, np.int64)
    lm = np.where(codes >= 0, codes, -codes - 1)
    end = lm + (codes >= 0)
    kend = np.minimum(end + (end & 1), W)
    if ordered:
        kend = np.concatenate([-np.sort(-kend[i:i + SEG])
                               for i in range(0, len(kend), SEG)])
    warp = np.concatenate([kend, np.zeros(-len(kend) % 32, np.int64)])
    warp = warp.reshape(-1, 32).max(axis=1)
    lane = live = 0
    for cs in range(0, W, split):
        ce = min(W, cs + split)
        lane += 32 * int(np.maximum(0, np.minimum(ce, warp) - cs).sum())
        live += int(np.maximum(0, np.minimum(end, ce) - cs).sum())
    passes = -(-K // 9)
    return passes * lane, passes * live


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("K", [3, 9, 20])
@pytest.mark.parametrize("N", [100, 1100])  # one column split; several
def test_engine_counts_match_the_host_rule(cuda, family, K, N):
    """The engine's `engine.lane_columns` / `engine.live_columns` equal the
    host's recomputation exactly, and `engine.slot_bytes` the bytes of the
    (B, K, 2) slots plus the split partials; with tracing off the kernels
    count nothing."""
    g = rng(0xC0 + 7 * K + N)
    B, W = 333, N + 2
    kernel = "gf_multihash" if family.startswith("gf_") else "multihash"
    split = mhk.split_of(kernel, B, W, cuda)
    splits = autotune.engine_splits(W, split)
    assert (splits > 1) == (N == 1100)
    codes = g.integers(-(N + 1), N + 1, size=B).astype(np.int32)
    codes[:6] = [0, -1, N, -(N + 1), min(split - 1, N), 31]
    codes[64:96] = 3  # a warp of short rows
    toks = t32(g.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32))
    keys = torch.from_numpy(g.integers(0, 2**64, (K, W + 1),
                                       dtype=np.uint64).view(np.int64))
    args = [a.to(cuda) for a in (toks, keys, torch.from_numpy(codes))]
    ops.multihash(*args, family=family, mod_m=M, width=W)  # tracing off
    tracing.enable()
    for _ in range(2):
        ops.multihash(*args, family=family, mod_m=M, width=W)
    tracing.disable()
    ops.multihash(*args, family=family, mod_m=M, width=W)  # off again
    counts = tracing.snapshot()["counters"]
    lane, live = engine_columns(codes, W, split, K)
    assert (counts["engine.lane_columns"], counts["engine.live_columns"]) == (
        2 * lane, 2 * live)
    part = splits * K * B * 8 if splits > 1 else 0
    assert counts["engine.slot_bytes"] == 2 * (B * K * 16 + part)


def test_lane_ratio_of_uniform_rows_is_one(cuda):
    """Rows of one length fill every lane of every warp they run: keys'
    13-grams (end 14 = kend = W) count lanes == live columns."""
    h = Hasher.from_spec(HashSpec(n_hashes=9, out_bits=64, variable_length=True,
                                  seed=3), max_len=13, device=cuda)
    toks = torch.randint(0, 32000, (4096, 13), dtype=torch.int32, device=cuda)
    lens = torch.full((4096,), 13, dtype=torch.int32, device=cuda)
    tracing.enable()
    h.probe_indices(toks, M, lens)
    tracing.disable()
    counts = tracing.snapshot()["counters"]
    assert counts["engine.lane_columns"] == counts["engine.live_columns"] == 4096 * 14
    splits = autotune.engine_splits(14, mhk.split_of("multihash", 4096, 14, cuda))
    part = splits * 9 * 4096 * 8 if splits > 1 else 0
    assert counts["engine.slot_bytes"] == 4096 * 9 * 16 + part


@pytest.mark.parametrize("N", [512, 4096])
def test_each_runtime_launch_lies_inside_its_launch_c_span(cuda, N):
    """The spans' clock is the profiler's: every cudaLaunchKernel of a
    profiled run of `probe_indices` calls lies inside a `launch.c` span,
    each span holds its call's launches, and each `launch.c` is a grandchild
    of its call's `hasher.hash_slots`."""
    B, calls = 256, 40
    h = Hasher.from_spec(HashSpec(n_hashes=9, out_bits=64, variable_length=True,
                                  seed=5), max_len=N, device=cuda)
    toks = torch.randint(0, 32000, (B, N), dtype=torch.int32, device=cuda)
    lens = torch.randint(0, N + 1, (B,), dtype=torch.int32, device=cuda)
    for _ in range(3):  # the build, the shared-memory opt-in
        h.probe_indices(toks, M, lens)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    tracing.enable()
    prof.start()
    for _ in range(calls):
        h.probe_indices(toks, M, lens)
    torch.cuda.synchronize()
    tracing.disable()
    prof.stop()
    snap = tracing.snapshot()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    spans = {s.id: s for s in snap["spans"]}
    boxes = sorted(((s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3, s.id)
                   for s in spans.values() if s.name == "launch.c")
    assert len(boxes) == calls
    for _, _, i in boxes:
        parent = spans[spans[i].parent]
        assert parent.name == "launch.multihash"
        assert spans[parent.parent].name == "hasher.hash_slots"
        assert spans[i].call == parent.parent
    launches = sorted((ev.time_range.start, ev.time_range.end)
                      for ev in prof.events() if ev.name.startswith("cudaLaunchKernel"))
    # the ordering kernel (B is two blocks' rows), the tile kernel and, with
    # several splits, the finish pass
    ordered = autotune.engine_orders(B, N + 2, autotune.engine_rows("multihash"), True)
    assert ordered
    per_call = 1 + ordered + (autotune.engine_splits(
        N + 2, mhk.split_of("multihash", B, N + 2, cuda, ordered)) > 1)
    assert len(launches) == calls * per_call
    held = {}
    for s, e in launches:
        inside = [i for b0, b1, i in boxes if b0 <= s and e <= b1]
        assert inside, (s, e)
        held[inside[0]] = held.get(inside[0], 0) + 1
    assert sorted(held.values()) == [per_call] * calls


def docs_lengths(g, B: int, N: int) -> np.ndarray:
    """Lengths like the benchmark's docs: exponential, mean 635, cut at N."""
    return np.minimum(N, 1 + g.exponential(635, B).astype(np.int64)).astype(np.int32)


@pytest.mark.parametrize("B", [65536, 2 * SEG + 1000])
@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear"])
def test_docs_batch_in_length_order_wastes_under_two_percent(cuda, family, B):
    """A docs batch (65,536 rows of up to 2,048 tokens, per-row lengths;
    again over three segments, the last a short one) runs its rows in
    length order: the kernels' own lane and live counts equal the host rule
    on the rows sorted in each segment, lanes within 1.02 of the live
    columns (3.16 in consecutive order), and each call counts once in
    `engine.ordered_calls`."""
    g = rng(0xD0C5)
    N, calls = 2048, 3
    h = Hasher.from_spec(HashSpec(family=family, n_hashes=9, out_bits=64,
                                  variable_length=True, seed=11),
                         max_len=N, device=cuda)
    lens = docs_lengths(g, B, N)
    toks = torch.randint(0, 32000, (B, N), dtype=torch.int32, device=cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    h.probe_indices(toks, M, lens_t)
    tracing.enable()
    for _ in range(calls):
        h.probe_indices(toks, M, lens_t)
    tracing.disable()
    counts = tracing.snapshot()["counters"]
    W = N + 2
    kernel = "gf_multihash" if family.startswith("gf_") else "multihash"
    split = mhk.split_of(kernel, B, W, cuda, ordered=True)
    lane, live = engine_columns(lens, W, split, 9, ordered=True)
    assert (counts["engine.lane_columns"], counts["engine.live_columns"]) == (
        calls * lane, calls * live)
    assert lane <= 1.02 * live
    assert engine_columns(lens, W, split, 9)[0] > 3 * live
    assert counts["engine.ordered_calls"] == calls


def test_bypass_calls_are_not_ordered(cuda):
    """Keys (W 14), one block's rows and calls without lengths keep the
    rows' order: `engine.ordered_calls` stays 0, and the lane counts follow
    the consecutive-rows rule."""
    h = Hasher.from_spec(HashSpec(n_hashes=9, out_bits=64, variable_length=True,
                                  seed=3), max_len=512, device=cuda)
    g = rng(0xB1)
    keys = torch.randint(0, 32000, (4096, 13), dtype=torch.int32, device=cuda)
    docs = torch.randint(0, 32000, (4096, 512), dtype=torch.int32, device=cuda)
    lens = g.integers(0, 513, 4096).astype(np.int32)
    tracing.enable()
    h.probe_indices(keys, M, torch.full((4096,), 13, dtype=torch.int32, device=cuda))
    h.probe_indices(docs[:100], M, torch.from_numpy(lens[:100]).to(cuda))
    h.probe_indices(docs, M)
    tracing.disable()
    counts = tracing.snapshot()["counters"]
    assert counts["engine.ordered_calls"] == 0
    lane = live = 0
    for codes, W in ((np.full(4096, 13), 14), (lens[:100], 514),
                     (np.full(4096, 512), 514)):
        split = mhk.split_of("multihash", len(codes), W, cuda)
        a, b = engine_columns(codes, W, split, 9)
        lane, live = lane + a, live + b
    assert (counts["engine.lane_columns"], counts["engine.live_columns"]) == (lane, live)
