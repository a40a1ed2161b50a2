"""Wrapper of the integer single-hash CUDA kernel (`csrc/multilinear.cu`).

Replaces the reference's Pallas `repro.kernels.multilinear.hash_blocks`
(`_multilinear_kernel`, `_multilinear_hm_kernel`) for the integer families
(multilinear, multilinear_2x2, multilinear_hm): the raw accumulator of one
keyed hash per row, without m1 and without the final >> 32. Operand layout:
see `kernels.ref` (single-hash layout).

A CUDA tensor launches the kernel (and adds one to `launch_count()`, the
counter `launch.multilinear` of `repro_torch.tracing`); a CPU tensor runs
the plain version `ref.multilinear_accumulate_ref`. Nothing else falls back.
"""
from __future__ import annotations

import torch

from .. import tracing
from . import _build, autotune, ref

_LAUNCHES = tracing.counter("launch.multilinear", always=True)


def launch_count() -> int:
    """Kernel launches since the last `reset_count()` (CUDA only): the
    counter `launch.multilinear` of `repro_torch.tracing`, kept whether
    tracing is on or off."""
    return _LAUNCHES.n


def reset_count() -> None:
    _LAUNCHES.n = 0


def launch_single(name: str, tokens, keys, family: str) -> torch.Tensor:
    """Launch single-hash kernel `name` on validated CUDA operands ->
    (B, 2) int64 (hi, lo); the per-tile partials go to a scratch tensor."""
    B, N = tokens.shape
    if -(-B // autotune.SINGLE["rows"]) > 65535:
        raise ValueError(f"{B} rows exceed the kernel grid's row groups")
    out = torch.empty((B, 2), dtype=torch.int64, device=tokens.device)
    if B == 0:
        return out
    tiles = autotune.single_tiles(ref.hashed_cols(N, family))
    part = (torch.empty((B, tiles), dtype=torch.int64, device=tokens.device)
            if tiles > 1 else out)  # unused with one tile
    _build.launch(name, tokens.device, tokens, keys, part, out, B, N,
                  int(family in ref.PAIRWISE))
    return out


def hash_blocks(tokens, keys, *, family="multilinear"):
    """(B, N) int32 tokens x (N,) int64 u64 keys (no m1) -> (B, 2) int64
    (hi, lo) of sum k_i s_i mod 2^64 (HM: over floor(N / 2) pairs)."""
    if tokens.device.type == "cpu":
        return ref.multilinear_accumulate_ref(tokens, keys, family=family)
    if tokens.device.type != "cuda":
        raise ValueError(f"no multilinear kernel for device {tokens.device}")
    ref.single_shapes(tokens, keys, family, ref.INT_FAMILIES)
    out = launch_single("multilinear", tokens, keys, family)
    _LAUNCHES.n += 1
    return out
