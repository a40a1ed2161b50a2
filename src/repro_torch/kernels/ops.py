"""Engine dispatch: one fused K-hash launch per call, any engine family.

The port's counterpart of `repro.kernels.ops.multihash`. It picks the
integer or the carry-less kernel wrapper by family; each wrapper launches
its CUDA kernel for a CUDA tensor and runs its plain version for a CPU
tensor. `launch_count()` counts engine dispatches on any device, as the
reference's does, so batch consumers can show one launch per batch on the
CPU too; each kernel module's own `launch_count()` counts only real CUDA
launches.
"""
from __future__ import annotations

from ..hash.spec import FAMILIES
from . import gf_multihash as gfmh
from . import multihash as mhk

_DISPATCHES = [0]


def launch_count() -> int:
    return _DISPATCHES[0]


def multihash(tokens, keys, lens, *, family="multilinear", mod_m=None,
              width=None):
    """(B, N) int32 tokens x (K, >= W+1) int64 keys -> (B, K, 2) int64 slots.

    See `kernels.ref` for the operand layout and the slot contract.
    """
    _DISPATCHES[0] += 1
    if FAMILIES[family].gf:
        return gfmh.gf_multihash(tokens, keys, lens, family=family,
                                 mod_m=mod_m, width=width)
    return mhk.multihash(tokens, keys, lens, family=family, mod_m=mod_m,
                         width=width)
