"""Launch configuration of the CUDA kernels.

The reference sweeps (block_b, block_n) tiles and persists the best per
problem bucket (`repro.kernels.autotune`). On the card the port compiles
one fixed configuration into the kernels (as `-D` defines, see
`_build.py`): in the fused multi-hash engine a block owns one token row
per thread and a split of the columns that `engine_split` picks from the
shape; in the integer single-hash kernel a block owns a `tile` of columns
for `rows` rows; in the carry-less one a warp owns 16 rows and a split of
the columns that `gf_single_split` picks. A measured sweep with its cache
is still to be ported (ROADMAP Queue 1).
"""
from __future__ import annotations

import functools

#: fused multi-hash engine (csrc/engine_tile.cuh): threads per block of the
#: integer and the carry-less kernel, one row per thread, and the blocks an
#: SM must hold (the kernels' launch bounds). The column tile is fixed at
#: 32, and K runs in register chunks of 1, 3 or 9.
ENGINE = {"int_threads": 128, "int_min_blocks": 4,
          "gf_threads": 256, "gf_min_blocks": 2}
ENGINE_TILE = 32
#: the widest rows the engine's row order takes (csrc/engine_tile.cuh,
#: `launch_order`: W / 2 + 1 buckets, counted in shared memory)
ENGINE_ORDER_MAX_WIDTH = 8192
#: (row block, split) units that a carry-less call whose rows are in length
#: order gives each resident block slot (`engine_split`'s `units`); the
#: integer kernel keeps the split of the wave rule alone, since its
#: partial sums cost the bytes it is bound by
ENGINE_GF_ORDERED_UNITS = 2
#: rows of the most row blocks one engine grid holds (65,535) over the rows
#: of a block: a longer batch runs in row chunks of that many
ENGINE_GRID_BLOCKS = 65535
#: the fewest columns a split takes, so a split's staging and epilogue stay
#: small beside its hashing, and the most (`csrc/engine_tile.cuh`
#: ET_MAX_SPLIT: the integer tensor-core path's s32 sums stay exact).
ENGINE_MIN_SPLIT = 256
ENGINE_MAX_SPLIT = 8192
#: integer single-hash kernel (csrc/single_hash.cuh): threads per block,
#: rows per block and columns per tile (the tile's keys sit in shared memory).
SINGLE = {"threads": 256, "rows": 32, "tile": 2048}
#: carry-less single-hash kernel (csrc/gf_single.cuh): threads per block, 16
#: rows a warp, and the blocks an SM must hold (the launch bounds of its
#: plain and its HM kernel); a split is a multiple of its 32-column step and
#: at most 2^26 columns (the b1 tensor cores' s32 counts stay exact).
GF_SINGLE = {"threads": 128, "min_blocks": 4, "hm_min_blocks": 8}
GF_SINGLE_STEP = 32
GF_SINGLE_MAX_SPLIT = 1 << 26


def pow2_at_least(x: int) -> int:
    """Next power of two >= x (exact bit arithmetic, no float log2)."""
    return 1 << max(0, int(x - 1).bit_length())


def single_tiles(cols: int) -> int:
    """Column tiles of a single-hash row of `cols` hashed columns (at least
    one); above one, the kernel combines per-tile partials in a second pass
    (`csrc/single_hash.cuh::single_hash_tiles`)."""
    return max(1, -(-cols // SINGLE["tile"]))


def _engine(kernel: str, key: str) -> int:
    return ENGINE[("gf_" if kernel == "gf_multihash" else "int_") + key]


def engine_rows(kernel: str) -> int:
    """Rows per block of engine kernel `kernel` (multihash, gf_multihash)."""
    return _engine(kernel, "threads")


def engine_fill(kernel: str, sms: int) -> int:
    """Blocks of engine kernel `kernel` that fill a card of `sms` SMs: as
    many as its launch bounds make each SM hold."""
    return sms * _engine(kernel, "min_blocks")


def engine_orders(B: int, W: int, rows: int, ragged: bool) -> bool:
    """Whether an engine call over B rows of width W, `rows` rows per block,
    puts its rows in length order (`csrc/engine_tile.cuh`): only where the
    caller gave per-row lengths (`ragged`), the rows span more than one
    column tile (below it every warp hashes one tile whatever its lengths)
    and no more than `ENGINE_ORDER_MAX_WIDTH` columns, and more than one
    block's rows (one block has no other rows to trade with)."""
    return ragged and ENGINE_TILE < W <= ENGINE_ORDER_MAX_WIDTH and B > rows


def engine_order_words(B: int, rows: int) -> int:
    """int32 words of an ordered engine call's scratch: the order of its
    longest row chunk."""
    return min(B, ENGINE_GRID_BLOCKS * rows)


@functools.lru_cache(maxsize=1024)
def engine_split(B: int, W: int, rows: int, fill: int, tile: int = ENGINE_TILE,
                 max_split: int = ENGINE_MAX_SPLIT, units: int = 0) -> int:
    """Columns per split of a fused multi-hash launch over B rows of width
    W, `rows` rows per block, on a card that `fill` blocks fill
    (`engine_fill`): all W (one split, the kernel runs the epilogue itself)
    when the row blocks alone fill the card; else the split count, up to
    the one that reaches `fill` blocks and with splits of at least
    `ENGINE_MIN_SPLIT` columns, whose waves of blocks take the least time
    (waves / splits; the fewest splits on a tie). With `units` (rows in
    length order: `ENGINE_GF_ORDERED_UNITS` for the carry-less kernel), at
    least the fewest splits that make `units` (row block, split) pairs for
    each of the `fill` slots, within the same least split: the longest rows' blocks, which start first, are
    then cut short enough that the rest of the card does not wait for
    them. A split is a multiple of the `tile` (the engine's 32 columns) and
    never more than `max_split` columns. A second pass then combines the
    splits exactly (`csrc/engine_tile.cuh`; `gf_single_split` for the
    carry-less single-hash kernel)."""
    row_blocks = max(1, -(-B // rows))
    most = max(1, min(-(-fill // row_blocks), W // ENGINE_MIN_SPLIT))
    best = 1
    for s in range(2, most + 1):
        # waves(s) / s < waves(best) / best
        if -(-s * row_blocks // fill) * best < -(-best * row_blocks // fill) * s:
            best = s
    if units:
        best = max(best, min(-(-units * fill // row_blocks),
                             max(1, W // ENGINE_MIN_SPLIT)))
    splits = max(best, -(-W // max_split))
    cols = -(-W // splits)
    return max(tile, -(-cols // tile) * tile)


def engine_splits(W: int, split: int) -> int:
    """Splits of W columns at `split` columns each (at least one), as the
    kernel's launcher counts them."""
    return -(-W // split) if W > split else 1


def gf_single_rows() -> int:
    """Rows per block of the carry-less single-hash kernel."""
    return GF_SINGLE["threads"] // 32 * 16


def gf_single_split(B: int, cols: int, sms: int, pairwise: bool = False) -> int:
    """Columns per split of a carry-less single-hash launch over B rows of
    `cols` hashed columns on a card of `sms` SMs: `engine_split`'s rule,
    filled to the resident blocks of the plain or (`pairwise`) HM kernel."""
    fill = sms * GF_SINGLE["hm_min_blocks" if pairwise else "min_blocks"]
    return engine_split(B, cols, gf_single_rows(), fill, tile=GF_SINGLE_STEP,
                        max_split=GF_SINGLE_MAX_SPLIT)


def nvcc_defines() -> list[str]:
    """The launch configurations as nvcc `-D` flags."""
    return ([f"-DET_{k.upper()}={v}" for k, v in ENGINE.items()]
            + [f"-DEO_MAX_WIDTH={ENGINE_ORDER_MAX_WIDTH}"]
            + [f"-DSH_{k.upper()}={v}" for k, v in SINGLE.items()]
            + [f"-DGS_{k.upper()}={v}" for k, v in GF_SINGLE.items()])
