"""The engine's length-ordered rows on the card (`csrc/engine_tile.cuh`,
`launch_order`): where the caller gives per-row lengths, the tile kernel
runs the rows in order of the columns each hashes, longest first, and its
slots still equal the plain version's exactly; where the rule does not
take the shape, the call puts one engine operation on the card.

Marked `gpu`: each test skips where no CUDA device exists (decided inside
the test). Run on the card with
`PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_engine_order.py`.
This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, rng, t32
from repro_torch import tracing
from repro_torch.hash import Hasher, HashSpec
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels import multihash as mhk

pytestmark = pytest.mark.gpu

M = 1_437_758_756  # the README's Bloom filter of 10**8 items at 1e-3
#: the plain and HM family of each engine
BOTH_FORMS = ["multilinear", "multilinear_hm", "gf_multilinear", "gf_multilinear_hm"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    tracing.disable()


def kernel_of(family: str) -> str:
    return "gf_multihash" if family.startswith("gf_") else "multihash"


def plain(family: str):
    return ref.gf_multihash_ref if family.startswith("gf_") else ref.multihash_ref


def codes_of(kind: str, g, B: int, N: int) -> np.ndarray:
    """Length codes: exponential lengths (mean N / 3) with 6 % of the rows
    at N, a few fixed-length codes and zeros among them; every row 0; every
    row full."""
    if kind == "zero":
        return np.zeros(B, np.int32)
    if kind == "full":
        return np.full(B, N, np.int32)
    codes = np.minimum(N, g.exponential(N / 3, B).astype(np.int64))
    codes[g.random(B) < 0.06] = N
    fixed = g.random(B) < 0.05
    codes[fixed] = -codes[fixed] - 1
    codes[:4] = [0, -1, N, -(N + 1)]
    return codes.astype(np.int32)


def operands(g, B: int, N: int, K: int, codes, device):
    W = N + 2
    toks = t32(g.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32))
    keys = torch.from_numpy(g.integers(0, 2**64, (K, W + 1),
                                       dtype=np.uint64).view(np.int64))
    return [a.to(device) for a in (toks, keys, torch.from_numpy(codes))], W


def ordered_call(args, family, mod_m, W):
    """One ragged engine call with the tracer on -> (slots, ordered calls)."""
    tracing.enable()
    got = ops.multihash(*args, family=family, mod_m=mod_m, width=W, ragged=True)
    tracing.disable()
    return got, tracing.snapshot()["counters"]["engine.ordered_calls"]


def plain_in_rows(args, family, mod_m, W, step: int = 4096) -> torch.Tensor:
    """The plain version a slab of rows at a time (its (B, W) temporaries)."""
    toks, keys, lens = args
    return torch.cat([plain(family)(toks[r:r + step], keys, lens[r:r + step],
                                    family=family, mod_m=mod_m, width=W)
                      for r in range(0, toks.shape[0], step)])


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("K", [3, 9, 20])
@pytest.mark.parametrize("N", [300, 1100])  # one column split; several
@pytest.mark.parametrize("kind", ["exp", "zero", "full"])
def test_ordered_slots_match_plain(cuda, family, K, N, kind):
    """B 1,000 (not a multiple of 32, 128 or 256 rows) with per-row lengths:
    the call is ordered, in one split at N 300 and several at N 1,100, and
    its slots equal the plain version's, with and without mod m."""
    g = rng(0x0DE + 13 * K + N + len(kind))
    B = 1000
    args, W = operands(g, B, N, K, codes_of(kind, g, B, N), cuda)
    split = mhk.split_of(kernel_of(family), B, W, cuda, ordered=True)
    assert (autotune.engine_splits(W, split) > 1) == (N == 1100)
    for mod_m in (None, M):
        got, ordered = ordered_call(args, family, mod_m, W)
        assert ordered == 1
        assert torch.equal(got, plain(family)(*args, family=family, mod_m=mod_m,
                                              width=W)), mod_m


@pytest.mark.parametrize("family", BOTH_FORMS)
def test_docs_batch_in_length_order_matches_plain(cuda, family):
    """A docs batch (65,536 rows of up to 2,048 tokens, K 9): the ordered
    slots equal the plain version's and the unordered call's."""
    g = rng(0xD0C)
    B, N, K = 65536, 2048, 9
    codes = np.minimum(N, 1 + g.exponential(635, B).astype(np.int64)).astype(np.int32)
    args, W = operands(g, B, N, K, codes, cuda)
    got, ordered = ordered_call(args, family, M, W)
    assert ordered == 1
    assert torch.equal(got, ops.multihash(*args, family=family, mod_m=M, width=W))
    assert torch.equal(got, plain_in_rows(args, family, M, W))


@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear"])
def test_segments_take_their_own_order(cuda, family):
    """Three segments of the order (65,536 rows each, the last 1,000): each
    is ordered by itself, and the slots equal the unordered call's and the
    plain version's."""
    g = rng(0x5E6)
    B, N, K = 2 * 65536 + 1000, 300, 9
    args, W = operands(g, B, N, K, codes_of("exp", g, B, N), cuda)
    got, ordered = ordered_call(args, family, M, W)
    assert ordered == 1
    assert torch.equal(got, ops.multihash(*args, family=family, mod_m=M, width=W))
    assert torch.equal(got, plain_in_rows(args, family, M, W))


def test_row_chunks_take_their_own_order(cuda):
    """More rows than one grid holds (65,535 blocks of 128): each row chunk
    is ordered by itself, and the slots equal the unordered call's, and the
    plain version's at both ends and across the chunk edge."""
    g = rng(0xC4)
    B, N = 65535 * 128 + 1000, 40
    W = N + 2
    args = [torch.randint(-2**31, 2**31 - 1, (B, N), dtype=torch.int32, device=cuda),
            torch.from_numpy(g.integers(0, 2**64, (1, W + 1),
                                        dtype=np.uint64).view(np.int64)).to(cuda),
            torch.from_numpy(g.integers(0, N + 1, B).astype(np.int32)).to(cuda)]
    got, ordered = ordered_call(args, "multilinear", None, W)
    assert ordered == 1
    assert torch.equal(got, ops.multihash(*args, family="multilinear", width=W))
    toks, keys, lens = args
    edge = 65535 * 128
    for r in (0, edge - 2048, B - 2048):
        assert torch.equal(got[r:r + 2048], ref.multihash_ref(
            toks[r:r + 2048], keys, lens[r:r + 2048], width=W)), r


def engine_ops(fn, tag: str) -> list:
    """Names of the device operations of one call of fn that carry the
    engine's tag (torch.profiler), in the order they ran."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in sorted(prof.events(), key=lambda e: e.time_range.start)
            if ev.device_type == torch.autograd.DeviceType.CUDA and tag in ev.name]


@pytest.mark.parametrize("case", ["keys", "one_block", "no_lengths"])
def test_bypass_puts_one_engine_operation_on_the_card(cuda, case):
    """W <= 32 (keys' 13-grams), B <= one block's rows (serve's prefix keys)
    and calls without lengths keep the rows' order: one engine operation,
    the tile kernel (each shape takes one split)."""
    B, N, lengths = {"keys": (4096, 13, True), "one_block": (100, 200, True),
                     "no_lengths": (65536, 512, False)}[case]
    h = Hasher.from_spec(HashSpec(n_hashes=9, out_bits=64, variable_length=True,
                                  seed=21), max_len=N, device=cuda)
    toks = torch.randint(0, 32000, (B, N), dtype=torch.int32, device=cuda)
    lens = torch.randint(0, N + 1, (B,), dtype=torch.int32, device=cuda)
    names = engine_ops(lambda: h.probe_indices(toks, M, lens if lengths else None),
                       "IntEngine")
    assert len(names) == 1 and "engine_tile_kernel" in names[0], names


@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear"])
def test_ordered_call_adds_one_operation(cuda, family):
    """A docs-shaped call with lengths: the ordering kernel, named after the
    engine, then the tile kernel and, where split, the finish pass."""
    B, N = 65536, 2048
    h = Hasher.from_spec(HashSpec(family=family, n_hashes=9, out_bits=64,
                                  variable_length=True, seed=22),
                         max_len=N, device=cuda)
    toks = torch.randint(0, 32000, (B, N), dtype=torch.int32, device=cuda)
    lens = torch.randint(0, N + 1, (B,), dtype=torch.int32, device=cuda)
    tag = "GfEngine" if family.startswith("gf_") else "IntEngine"
    names = engine_ops(lambda: h.probe_indices(toks, M, lens), tag)
    split = mhk.split_of(kernel_of(family), B, N + 2, cuda, ordered=True)
    finish = autotune.engine_splits(N + 2, split) > 1
    want = ["engine_order_kernel", "engine_tile_kernel", "engine_finish"][:2 + finish]
    assert len(names) == len(want), names
    for name, w in zip(names, want):
        assert w in name, names
