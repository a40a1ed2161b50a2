"""Launch configuration of the CUDA kernels.

The reference sweeps (block_b, block_n) tiles and persists the best per
problem bucket (`repro.kernels.autotune`). On the card the port compiles
one fixed configuration into the kernels (as `-D` defines, see
`_build.py`): in the fused multi-hash engine each block owns `rows` token
rows and the whole column loop; in the single-hash kernels a block owns a
`tile` of columns for `rows` rows. A measured sweep and its cache are
still to be ported (ROADMAP Queue 1).
"""
from __future__ import annotations

#: threads per block, rows per block, and hash functions per register pass
#: (K is looped in chunks of `k_chunk`; any K >= 1 works).
LAUNCH = {"threads": 128, "rows": 4, "k_chunk": 8}
#: single-hash kernels (csrc/single_hash.cuh): threads per block, rows per
#: block and columns per tile (the tile's keys sit in shared memory).
SINGLE = {"threads": 256, "rows": 32, "tile": 2048}


def pow2_at_least(x: int) -> int:
    """Next power of two >= x (exact bit arithmetic, no float log2)."""
    return 1 << max(0, int(x - 1).bit_length())


def single_tiles(cols: int) -> int:
    """Column tiles of a single-hash row of `cols` hashed columns (at least
    one); above one, the kernel combines per-tile partials in a second pass
    (`csrc/single_hash.cuh::single_hash_tiles`)."""
    return max(1, -(-cols // SINGLE["tile"]))


def nvcc_defines() -> list[str]:
    """The launch configurations as nvcc `-D` flags."""
    return ([f"-DMH_{k.upper()}={v}" for k, v in LAUNCH.items()]
            + [f"-DSH_{k.upper()}={v}" for k, v in SINGLE.items()])
