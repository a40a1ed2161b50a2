"""Launch configuration of the fused multi-hash kernels.

The reference sweeps (block_b, block_n) tiles and persists the best per
problem bucket (`repro.kernels.autotune`). On the card each block owns
`rows` token rows and the whole column loop, so there is no n tile to
choose; the port compiles one fixed configuration into both kernels (as
`-D` defines, see `_build.py`). A measured sweep and its cache are still to
be ported (ROADMAP Queue 1).
"""
from __future__ import annotations

#: threads per block, rows per block, and hash functions per register pass
#: (K is looped in chunks of `k_chunk`; any K >= 1 works).
LAUNCH = {"threads": 128, "rows": 4, "k_chunk": 8}


def pow2_at_least(x: int) -> int:
    """Next power of two >= x (exact bit arithmetic, no float log2)."""
    return 1 << max(0, int(x - 1).bit_length())


def nvcc_defines() -> list[str]:
    """The launch configuration as nvcc `-D` flags."""
    return [f"-DMH_{k.upper()}={v}" for k, v in LAUNCH.items()]
