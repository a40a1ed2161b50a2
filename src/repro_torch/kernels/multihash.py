"""Wrapper of the fused integer multi-hash CUDA kernel (`csrc/multihash.cu`).

Replaces the reference's Pallas `repro.kernels.multihash.multihash_blocks`
for the integer families (multilinear, multilinear_2x2, multilinear_hm).
Operand layout and slots: see `kernels.ref`. The output is (B, K, 2) int64
holding u32 values.

A CUDA tensor launches the kernel (and adds one to `launch_count()`, the
counter `launch.multihash` of `repro_torch.tracing`); a CPU tensor runs the
plain version `ref.multihash_ref`. Nothing else falls back. While tracing
is on, `launch_engine` of either engine adds the bytes of its slots and
split partials to `engine.slot_bytes`, counts its length-ordered calls in
`engine.ordered_calls` and hands the kernels the card's
`engine.lane_columns` / `engine.live_columns` buffer.
"""
from __future__ import annotations

import functools

import torch

from .. import tracing
from ..core.limbs import as_plan
from . import _build, autotune, ref

_LAUNCHES = tracing.counter("launch.multihash", always=True)
_SLOT_BYTES = tracing.counter("engine.slot_bytes")
_ORDERED = tracing.counter("engine.ordered_calls")


def launch_count() -> int:
    """Kernel launches since the last `reset_count()` (CUDA only): the
    counter `launch.multihash` of `repro_torch.tracing`, kept whether
    tracing is on or off."""
    return _LAUNCHES.n


def reset_count() -> None:
    _LAUNCHES.n = 0


def multihash(tokens, keys, lens, *, family="multilinear", mod_m=None,
              width=None, ragged=False):
    """K integer hashes of every row of `tokens` -> (B, K, 2) int64 slots.
    `ragged`: the caller gave per-row lengths (`launch_engine`)."""
    if tokens.device.type == "cpu":
        return ref.multihash_ref(tokens, keys, lens, family=family,
                                 mod_m=mod_m, width=width)
    if tokens.device.type != "cuda":
        raise ValueError(f"no multihash kernel for device {tokens.device}")
    W = ref.engine_shapes(tokens, keys, lens, width, family)[3]
    if family not in ref.INT_FAMILIES:
        raise ValueError(f"{family!r} is not an integer engine family")
    out = launch_engine("multihash", tokens, keys, lens, family, mod_m, W,
                        ragged)
    _LAUNCHES.n += int(out.shape[0] > 0)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_of(name: str, B: int, W: int, device, ordered: bool = False) -> int:
    """Columns per split that `launch_engine` gives engine kernel `name`
    for B rows of width W on CUDA `device` (`autotune.engine_split`, filled
    to the device's SMs; `ordered`: rows in length order)."""
    return autotune.engine_split(
        B, W, autotune.engine_rows(name),
        autotune.engine_fill(name, _sm_count(device)),
        units=autotune.ENGINE_GF_ORDERED_UNITS
        if ordered and name == "gf_multihash" else 0)


@functools.lru_cache(maxsize=1024)
def _plan(name: str, B: int, W: int, K: int, ragged: bool, device) -> tuple:
    """(ordered, columns per split, int64 words of split partials, int64
    words of scratch) of an engine call: whether its rows run in length
    order (`autotune.engine_orders`), its split (`split_of`), and one
    scratch for the partials (where split) and the order."""
    rows = autotune.engine_rows(name)
    ordered = autotune.engine_orders(B, W, rows, ragged)
    split = split_of(name, B, W, device, ordered)
    splits = autotune.engine_splits(W, split)
    n_part = splits * K * B if splits > 1 else 0
    n_order = autotune.engine_order_words(B, rows) if ordered else 0
    return ordered, split, n_part, n_part + -(-n_order // 2)


def launch_engine(name: str, tokens, keys, lens, family: str, mod_m,
                  W: int, ragged: bool = False) -> torch.Tensor:
    """Launch engine kernel `name` on validated CUDA operands -> (B, K, 2)
    int64 slots. Where the caller gave per-row lengths (`ragged`) and
    `autotune.engine_orders` takes the shape, the rows run in length order:
    an ordering kernel sorts the places of the call's rows by the columns
    each hashes, longest first, in segments of 65,536 rows (one a call at
    the docs shape), and the tile kernel gives each lane the row at its
    place, so a warp's 32 rows end close together. Above one column split
    (`autotune.engine_split`) the per-split partial sums go to scratch and
    the kernel's second pass combines them; more rows than one grid holds
    (65,535 row blocks) run in row chunks inside the C launcher. It is one
    call of the C launcher either way,
    with one scratch tensor for the partials and the order. While tracing
    is on it counts the bytes of `out` and of the partials (where split) in
    `engine.slot_bytes` and an ordered call in `engine.ordered_calls`, and
    the kernels add their lane and live columns to the card's
    `tracing.engine_counts`; off, they get a null pointer."""
    B, N = tokens.shape
    K = keys.shape[0]
    plan = as_plan(mod_m)
    out = torch.empty((B, K, 2), dtype=torch.int64, device=tokens.device)
    if B == 0:
        return out
    ordered, split, n_part, n_scratch = _plan(name, B, W, K, ragged, tokens.device)
    scratch = part = order = None
    if n_scratch:
        scratch = torch.empty(n_scratch, dtype=torch.int64, device=tokens.device)
        part = scratch.data_ptr()
        order = part + 8 * n_part if ordered else None
    stats = None
    if tracing.ON:
        _SLOT_BYTES.n += 8 * (out.numel() + n_part)
        _ORDERED.n += ordered
        stats = tracing.engine_counts(tokens.device)
    _build.launch(name, tokens.device, tokens, keys, lens, out,
                  out if part is None else part, B, N, W, K, keys.stride(0),
                  int(family in ref.PAIRWISE), split,
                  0 if plan is None else plan.m, order, stats)
    return out
