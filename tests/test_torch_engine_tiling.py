"""The fused engine's column split (`repro_torch.kernels.autotune.
engine_split`) and when its rows run in length order (`engine_orders`),
which the CUDA launcher (`csrc/engine_tile.cuh`) takes as they are: plain
Python, so they are checked here on the CPU, for a card of 132 SMs (the
H100 SXM)."""
import numpy as np
import pytest
import torch

from repro_torch.hash import Hasher, HashSpec
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops

TILE = autotune.ENGINE_TILE
ROWS = autotune.engine_rows("multihash")
SMS = 132
FILL = autotune.engine_fill("multihash", SMS)


def splits_of(B, W, rows=ROWS, fill=FILL, units=0):
    split = autotune.engine_split(B, W, rows, fill, units=units)
    return split, autotune.engine_splits(W, split)


def waves_per_split(B, W, rows, fill):
    """Time of a launch in block-waves of one split's length (the split
    count's cost as `engine_split` weighs it)."""
    S = splits_of(B, W, rows, fill)[1]
    return -(-S * -(-B // rows) // fill) / S


def test_pure_shape_is_one_split():
    """B 65,536 x W 1,026 (phase 3): the row blocks fill the card alone
    (512 of the integer kernel's 528 resident blocks): no second pass."""
    for kernel in ("multihash", "gf_multihash"):
        rows = autotune.engine_rows(kernel)
        split, S = splits_of(65536, 1026, rows, autotune.engine_fill(kernel, SMS))
        assert S == 1 and split >= 1026, kernel


def test_admission_batch_splits_columns():
    """B 8,192 x W 2,050 (an admission batch): 64 integer row blocks (4 a
    SM) or 32 carry-less ones (2 a SM), so the columns are split into 8
    ranges of 288 (9 tiles): 512 and 256 blocks, one wave each."""
    for kernel in ("multihash", "gf_multihash"):
        rows = autotune.engine_rows(kernel)
        fill = autotune.engine_fill(kernel, SMS)
        split, S = splits_of(8192, 2050, rows, fill)
        assert (split, S) == (288, 8), kernel
        assert S * -(-8192 // rows) <= fill


def test_fill_follows_each_kernels_resident_blocks():
    assert autotune.engine_fill("multihash", SMS) == SMS * autotune.ENGINE["int_min_blocks"]
    assert autotune.engine_fill("gf_multihash", SMS) == SMS * autotune.ENGINE["gf_min_blocks"]
    assert autotune.engine_rows("gf_multihash") == autotune.ENGINE["gf_threads"]


@pytest.mark.parametrize("W", [0, 1, 2, 1026, 2050, autotune.ENGINE_MAX_SPLIT])
@pytest.mark.parametrize("B", [ROWS * FILL, 65536, 1 << 20])
def test_one_split_when_rows_fill_the_card(B, W):
    assert splits_of(B, W)[1] == 1


@pytest.mark.parametrize("W", [1, 2, 31, 255, 256, 511, 512, 2050, 65536,
                               (1 << 20) - 2, 1 << 20])
@pytest.mark.parametrize("B", [1, 31, 33, 129, 8192, 20000, 1 << 20])
def test_split_is_bounded_and_covers_the_row(B, W):
    split, S = splits_of(B, W)
    row_blocks = -(-B // ROWS)
    assert split % TILE == 0 and split >= TILE
    assert (S - 1) * split < W <= S * split or (S == 1 and W <= split)
    assert split <= autotune.ENGINE_MAX_SPLIT
    assert 1 <= S <= max(1, W // autotune.ENGINE_MIN_SPLIT)
    # no more splits than the fill target or the widest split asks for
    wide = -(-W // autotune.ENGINE_MAX_SPLIT)
    assert S <= max(1, wide, -(-FILL // row_blocks))
    if S > max(1, wide):
        assert split >= autotune.ENGINE_MIN_SPLIT


@pytest.mark.parametrize("B,W", [(8192, 2050), (20000, 2050), (300, 4096),
                                 (40000, 1026), (1, 1 << 20)])
def test_split_count_takes_the_fewest_waves(B, W):
    """No split count within the limits finishes in fewer waves a split than
    the one picked (20,000 rows: 157 blocks, so 3 splits fill one wave, 4
    would take two). A count is taken as the launcher sees it, after the
    split is rounded up to whole tiles."""
    got = waves_per_split(B, W, ROWS, FILL)
    row_blocks = -(-B // ROWS)
    for s in range(1, max(1, min(-(-FILL // row_blocks),
                                 W // autotune.ENGINE_MIN_SPLIT)) + 1):
        s = autotune.engine_splits(W, -(-(-(-W // s)) // TILE) * TILE)
        assert got <= -(-s * row_blocks // FILL) / s


@pytest.mark.parametrize("W,split,S", [(0, 32, 1), (32, 32, 1), (33, 32, 2),
                                       (2050, 416, 5), (2080, 416, 5),
                                       (2081, 416, 6)])
def test_splits_count_like_the_launcher(W, split, S):
    assert autotune.engine_splits(W, split) == S


def test_nvcc_defines_name_the_engine_rows():
    assert f"-DET_INT_THREADS={ROWS}" in autotune.nvcc_defines()
    assert "-DET_GF_MIN_BLOCKS=2" in autotune.nvcc_defines()
    assert not any(d.startswith("-DMH_") for d in autotune.nvcc_defines())


def test_nvcc_defines_name_the_row_order_limits():
    defs = autotune.nvcc_defines()
    assert f"-DEO_MAX_WIDTH={autotune.ENGINE_ORDER_MAX_WIDTH}" in defs
    assert not any(d.startswith("-DEO_BLOCKS") for d in defs)


@pytest.mark.parametrize("kernel", ["multihash", "gf_multihash"])
def test_docs_batch_is_ordered(kernel):
    """B 65,536 x W 2,050 with per-row lengths (a docs batch): ordered."""
    assert autotune.engine_orders(65536, 2050, autotune.engine_rows(kernel), True)


@pytest.mark.parametrize("kernel", ["multihash", "gf_multihash"])
@pytest.mark.parametrize("B,W,ragged", [
    (1048576, 14, True),    # keys' 13-grams: one tile a row
    (1048576, 32, True),    # still one tile
    (8, 514, True),         # serve's prefix keys: one block's rows
    (65536, 2050, False),   # no lengths (tree leaves, the hash router)
    (65536, autotune.ENGINE_ORDER_MAX_WIDTH + 2, True),  # buckets too many
])
def test_bypass_keeps_the_order_of_the_rows(kernel, B, W, ragged):
    assert not autotune.engine_orders(B, W, autotune.engine_rows(kernel), ragged)


@pytest.mark.parametrize("kernel", ["multihash", "gf_multihash"])
def test_order_engages_at_the_edges(kernel):
    """Just past one tile, one block's rows, and at the widest order."""
    rows = autotune.engine_rows(kernel)
    wide = autotune.ENGINE_ORDER_MAX_WIDTH
    assert autotune.engine_orders(rows + 1, 33, rows, True)
    assert not autotune.engine_orders(rows, 2050, rows, True)
    assert autotune.engine_orders(rows + 1, wide, rows, True)


def test_ordered_docs_split_per_engine():
    """B 65,536 x W 2,050 in length order: the carry-less kernel's 256 row
    blocks take 3 splits (768 units, at least 2 for each of its 264 slots),
    the integer kernel's 512 keep one split (its rule has no extra units);
    unordered, both take one."""
    want = {"multihash": 1, "gf_multihash": 3}
    for kernel, S in want.items():
        rows = autotune.engine_rows(kernel)
        fill = autotune.engine_fill(kernel, SMS)
        units = autotune.ENGINE_GF_ORDERED_UNITS if kernel == "gf_multihash" else 0
        split, got = splits_of(65536, 2050, rows, fill, units)
        assert got == S, kernel
        assert S * -(-65536 // rows) >= units * fill
        assert splits_of(65536, 2050, rows, fill)[1] == 1


@pytest.mark.parametrize("B", [257, 8192, 20000, 65536, 1 << 20])
@pytest.mark.parametrize("W", [34, 300, 1026, 2050, 8192])
def test_ordered_split_fills_its_units_within_the_least_split(B, W):
    """An ordered carry-less call takes at least the units' splits, unless
    that would cut a split below `ENGINE_MIN_SPLIT` columns, and never
    fewer splits than the unordered rule; a count is taken as the launcher
    sees it, after the split is rounded up to whole tiles."""
    kernel = "gf_multihash"
    rows = autotune.engine_rows(kernel)
    fill = autotune.engine_fill(kernel, SMS)
    units = autotune.ENGINE_GF_ORDERED_UNITS
    split, S = splits_of(B, W, rows, fill, units)
    assert split % TILE == 0 and (S - 1) * split < W <= S * split or S == 1
    assert S >= splits_of(B, W, rows, fill)[1]
    need = min(-(-units * fill // -(-B // rows)),
               max(1, W // autotune.ENGINE_MIN_SPLIT))
    assert S >= autotune.engine_splits(W, -(-(-(-W // need)) // TILE) * TILE)


@pytest.mark.parametrize("B,rows,words", [
    (65536, 128, 65536),
    (65536, 256, 65536),
    (1 << 24, 128, 65535 * 128),  # the longest row chunk
])
def test_order_scratch_holds_a_chunk(B, rows, words):
    assert autotune.engine_order_words(B, rows) == words


@pytest.mark.parametrize("call", ["call", "probe_indices", "hash_batch"])
@pytest.mark.parametrize("given", [False, True])
def test_hasher_marks_calls_with_lengths_ragged(monkeypatch, call, given):
    """The Hasher tells the engine the caller gave per-row lengths (the one
    thing the order's rule takes from the caller), and only then; the slots
    are the same either way."""
    seen = []
    real = kops.multihash

    def spy(*args, **kw):
        seen.append(kw["ragged"])
        return real(*args, **kw)

    monkeypatch.setattr(kops, "multihash", spy)
    h = Hasher.from_spec(HashSpec(n_hashes=3, out_bits=64, variable_length=True,
                                  seed=9), max_len=40, device="cpu")
    toks = torch.randint(0, 1000, (6, 40), dtype=torch.int32)
    lens = np.array([0, 1, 40, 17, 33, 2]) if given else None
    if call == "call":
        h(toks, lens)
    elif call == "probe_indices":
        h.probe_indices(toks, 4097, lens)
    else:
        h.hash_batch(toks.numpy().view(np.uint32), lengths=lens)
    assert seen == [given]


def test_ragged_flag_leaves_cpu_slots_unchanged():
    g = np.random.default_rng(5)
    toks = torch.from_numpy(g.integers(0, 2**31, (40, 50)).astype(np.int32))
    keys = torch.from_numpy(g.integers(0, 2**62, (3, 53)))
    lens = torch.from_numpy(g.integers(0, 51, 40).astype(np.int32))
    for family in ("multilinear", "gf_multilinear_hm"):
        a = kops.multihash(toks, keys, lens, family=family, width=52)
        b = kops.multihash(toks, keys, lens, family=family, width=52, ragged=True)
        assert torch.equal(a, b)
