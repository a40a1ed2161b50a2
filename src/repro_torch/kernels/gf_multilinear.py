"""Wrapper of the carry-less single-hash CUDA kernel
(`csrc/gf_multilinear.cu` on `csrc/gf_single.cuh`).

Replaces the reference's Pallas `repro.kernels.gf_multilinear.
gf_hash_blocks` (`_gf_kernel`, `_gf_hm_kernel`) for the GF(2^32) families
(gf_multilinear, gf_multilinear_hm), in two modes of one kernel:

- `gf_hash_blocks`: the raw 63-bit xor accumulator of one keyed hash per
  row, without m1 and without the Barrett reduction (the reference's
  contract);
- `gf_hash_rows`: the finished hashes Barrett(acc ^ m1) mod p(x), with m1
  read on the card as key 0, so `ops.gf_hash` is one launch.

Operand layout: see `kernels.ref` (single-hash layout). A CUDA tensor
launches the kernel (and adds one to `launch_count()`, the counter
`launch.gf_multilinear` of `repro_torch.tracing`); a CPU tensor runs the
plain version (`ref.gf_accumulate_ref`, `ref.gf_hash_ref`). Nothing
else falls back.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import _build, autotune, ref
from .multihash import _sm_count

_LAUNCHES = tracing.counter("launch.gf_multilinear", always=True)


def launch_count() -> int:
    """Kernel launches since the last `reset_count()` (CUDA only): the
    counter `launch.gf_multilinear` of `repro_torch.tracing`, kept whether
    tracing is on or off."""
    return _LAUNCHES.n


def reset_count() -> None:
    _LAUNCHES.n = 0


def split_of(B: int, N: int, family: str, device) -> int:
    """Columns per split the launch gives B rows of N tokens on `device`."""
    return autotune.gf_single_split(B, ref.hashed_cols(N, family),
                                    _sm_count(torch.device(device)),
                                    family in ref.PAIRWISE)


def _launch(tokens, keys, family: str, finish: bool) -> torch.Tensor:
    """One call of the C launcher on validated CUDA operands; the split's
    partials go to a scratch tensor."""
    if tokens.device.type != "cuda":
        raise ValueError(f"no gf_multilinear kernel for device {tokens.device}")
    ref.single_shapes(tokens, keys[1:] if finish else keys, family, ref.GF_FAMILIES)
    B, N = tokens.shape
    if -(-B // autotune.gf_single_rows()) > 65535:
        raise ValueError(f"{B} rows exceed the kernel grid's row blocks")
    out = torch.empty((B,) if finish else (B, 2), dtype=torch.int64,
                      device=tokens.device)
    if B == 0:
        return out
    split = split_of(B, N, family, tokens.device)
    splits = max(1, -(-ref.hashed_cols(N, family) // split))
    part = (torch.empty((B, splits), dtype=torch.int64, device=tokens.device)
            if splits > 1 else out)  # unused with one split
    _build.launch("gf_multilinear", tokens.device, tokens, keys, part, out, B,
                  N, int(family in ref.PAIRWISE), int(finish), split)
    _LAUNCHES.n += 1
    return out


def gf_hash_blocks(tokens, keys32, *, family="gf_multilinear"):
    """(B, N) int32 tokens x (N,) int32 u32 keys (no m1) -> (B, 2) int64
    (hi, lo) of the xor of clmul(k_i, s_i) (HM: over floor(N / 2) pairs)."""
    if tokens.device.type == "cpu":
        return ref.gf_accumulate_ref(tokens, keys32, family=family)
    return _launch(tokens, keys32, family, finish=False)


def gf_hash_rows(tokens, keys32, *, family="gf_multilinear"):
    """(B, N) int32 tokens x (N + 1,) int32 u32 keys, key 0 m1 -> (B,)
    int64 hashes Barrett(acc ^ m1) mod p(x), in one launch on the card."""
    if tokens.device.type == "cpu":
        return ref.gf_hash_ref(tokens, keys32[1:], keys32[0], family=family)
    return _launch(tokens, keys32, family, finish=True)


def b1_mma_rate(device, iters: int = 4096) -> float:
    """m16n8k256 b1 and/popc mma products a second on CUDA `device`, timed
    with CUDA events over a loop of the instruction alone
    (`csrc/gf_single.cuh::gf_b1_rate`, every SM x the kernel's resident
    blocks); the plain family's design floor divides its mma count by it."""
    device = torch.device(device)
    blocks = _sm_count(device) * autotune.GF_SINGLE["min_blocks"]
    threads = autotune.GF_SINGLE["threads"]
    sink = torch.empty(blocks * threads, dtype=torch.int32, device=device)
    fn = _build.c_function("gf_multilinear", "repro_gf_multilinear_b1_rate",
                           [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p])

    def run(n):
        err = fn(blocks, n, sink.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"b1 rate probe failed: CUDA error {err}")

    with torch.cuda.device(device):
        run(16)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run(iters)
        stop.record()
        stop.synchronize()
    return blocks * (threads // 32) * iters * 8 / (start.elapsed_time(stop) / 1e3)
