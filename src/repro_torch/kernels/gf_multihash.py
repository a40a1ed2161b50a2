"""Wrapper of the fused carry-less multi-hash CUDA kernel
(`csrc/gf_multihash.cu`).

Replaces the reference's Pallas `repro.kernels.gf_multihash.
gf_multihash_blocks` for the GF(2^32) families (gf_multilinear,
gf_multilinear_hm), which use the low 32 bits of each key.
Operand layout and slots: see `kernels.ref`. The output is (B, K, 2) int64
holding u32 values.

A CUDA tensor launches the kernel (and adds one to `launch_count()`, the
counter `launch.gf_multihash` of `repro_torch.tracing`); a CPU tensor runs
the plain version `ref.gf_multihash_ref`. Nothing else falls back. Its
engine counters are `multihash.launch_engine`'s.
"""
from __future__ import annotations

from .. import tracing
from . import ref
from .multihash import launch_engine

_LAUNCHES = tracing.counter("launch.gf_multihash", always=True)


def launch_count() -> int:
    """Kernel launches since the last `reset_count()` (CUDA only): the
    counter `launch.gf_multihash` of `repro_torch.tracing`, kept whether
    tracing is on or off."""
    return _LAUNCHES.n


def reset_count() -> None:
    _LAUNCHES.n = 0


def gf_multihash(tokens, keys, lens, *, family="gf_multilinear",
                 mod_m=None, width=None, ragged=False):
    """K carry-less hashes of every row of `tokens` -> (B, K, 2) int64 slots.
    `ragged`: the caller gave per-row lengths (`multihash.launch_engine`)."""
    if tokens.device.type == "cpu":
        return ref.gf_multihash_ref(tokens, keys, lens, family=family,
                                    mod_m=mod_m, width=width)
    if tokens.device.type != "cuda":
        raise ValueError(f"no gf_multihash kernel for device {tokens.device}")
    W = ref.engine_shapes(tokens, keys, lens, width, family)[3]
    if family not in ref.GF_FAMILIES:
        raise ValueError(f"{family!r} is not a carry-less engine family")
    out = launch_engine("gf_multihash", tokens, keys, lens, family, mod_m, W,
                        ragged)
    _LAUNCHES.n += int(out.shape[0] > 0)
    return out
