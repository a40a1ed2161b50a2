"""Wrapper of the fused integer multi-hash CUDA kernel (`csrc/multihash.cu`).

Replaces the reference's Pallas `repro.kernels.multihash.multihash_blocks`
for the integer families (multilinear, multilinear_2x2, multilinear_hm).
Operand layout and slots: see `kernels.ref`. The output is (B, K, 2) int64
holding u32 values.

A CUDA tensor launches the kernel (and adds one to `launch_count()`); a CPU
tensor runs the plain version `ref.multihash_ref`. Nothing else falls back.
"""
from __future__ import annotations

import torch

from ..core.limbs import as_plan
from . import _build, ref

_LAUNCHES = [0]


def launch_count() -> int:
    """Kernel launches since the last `reset_count()` (CUDA only)."""
    return _LAUNCHES[0]


def reset_count() -> None:
    _LAUNCHES[0] = 0


def multihash(tokens, keys, lens, *, family="multilinear", mod_m=None,
              width=None):
    """K integer hashes of every row of `tokens` -> (B, K, 2) int64 slots."""
    if tokens.device.type == "cpu":
        return ref.multihash_ref(tokens, keys, lens, family=family,
                                 mod_m=mod_m, width=width)
    if tokens.device.type != "cuda":
        raise ValueError(f"no multihash kernel for device {tokens.device}")
    B, N, K, W = ref.engine_shapes(tokens, keys, lens, width, family)
    if family not in ref.INT_FAMILIES:
        raise ValueError(f"{family!r} is not an integer engine family")
    plan = as_plan(mod_m)
    out = torch.empty((B, K, 2), dtype=torch.int64, device=tokens.device)
    if B == 0:
        return out
    _build.launch("multihash", tokens.device, tokens, keys, lens, out,
                  B, N, W, K, keys.stride(0), int(family in ref.PAIRWISE),
                  0 if plan is None else plan.m)
    _LAUNCHES[0] += 1
    return out
