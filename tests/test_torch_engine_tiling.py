"""The fused engine's column split (`repro_torch.kernels.autotune.
engine_split`), which the CUDA launcher (`csrc/engine_tile.cuh`) takes as
it is: plain Python, so it is checked here on the CPU, for a card of 132
SMs (the H100 SXM)."""
import pytest

from repro_torch.kernels import autotune

TILE = autotune.ENGINE_TILE
ROWS = autotune.engine_rows("multihash")
SMS = 132
FILL = autotune.engine_fill("multihash", SMS)


def splits_of(B, W, rows=ROWS, fill=FILL):
    split = autotune.engine_split(B, W, rows, fill)
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
