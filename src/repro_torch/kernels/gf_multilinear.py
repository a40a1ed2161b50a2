"""Wrapper of the carry-less single-hash CUDA kernel
(`csrc/gf_multilinear.cu`).

Replaces the reference's Pallas `repro.kernels.gf_multilinear.
gf_hash_blocks` (`_gf_kernel`, `_gf_hm_kernel`) for the GF(2^32) families
(gf_multilinear, gf_multilinear_hm): the raw 63-bit xor accumulator of one
keyed hash per row, without m1 and without the Barrett reduction. Operand
layout: see `kernels.ref` (single-hash layout).

A CUDA tensor launches the kernel (and adds one to `launch_count()`); a CPU
tensor runs the plain version `ref.gf_accumulate_ref`. Nothing else falls
back.
"""
from __future__ import annotations

from . import ref
from .multilinear import launch_single

_LAUNCHES = [0]


def launch_count() -> int:
    """Kernel launches since the last `reset_count()` (CUDA only)."""
    return _LAUNCHES[0]


def reset_count() -> None:
    _LAUNCHES[0] = 0


def gf_hash_blocks(tokens, keys32, *, family="gf_multilinear"):
    """(B, N) int32 tokens x (N,) int32 u32 keys (no m1) -> (B, 2) int64
    (hi, lo) of the xor of clmul(k_i, s_i) (HM: over floor(N / 2) pairs)."""
    if tokens.device.type == "cpu":
        return ref.gf_accumulate_ref(tokens, keys32, family=family)
    if tokens.device.type != "cuda":
        raise ValueError(f"no gf_multilinear kernel for device {tokens.device}")
    ref.single_shapes(tokens, keys32, family, ref.GF_FAMILIES)
    out = launch_single("gf_multilinear", tokens, keys32, family)
    _LAUNCHES[0] += 1
    return out
