"""Launch layer: the fused K-hash engine dispatch and the single-hash entry
points.

The port's counterpart of `repro.kernels.ops`:

- `multihash` picks the integer or the carry-less engine wrapper by family;
  `launch_count()` counts engine dispatches on any device, as the
  reference's does, so batch consumers can show one launch per batch on
  the CPU too (each kernel module's own `launch_count()` counts only real
  CUDA launches). The count is the counter `launch.dispatch` of
  `repro_torch.tracing`, kept whether tracing is on or off; while tracing
  is on, each dispatch is a span `launch.multihash` (the dispatch and the
  wrapper, down to the C launcher's own span `launch.c`);
- `multilinear_hash`, `gf_hash` and `hash_tokens_batched` compute one keyed
  hash of each fixed-length row, drawing from one key string with key 0 as
  m1. `multilinear_hash` takes the raw accumulator from its kernel
  wrapper (`kernels.multilinear`) and adds m1 and the >> 32 here, as the
  reference does; `gf_hash` is one launch of the carry-less kernel
  (`kernels.gf_multilinear.gf_hash_rows`), which xors m1 in and runs the
  Barrett reduction in the pass that writes each row. The reference's `backend`/`block_b`/`block_n` arguments are
  gone: the tensors' device decides, and the tiling belongs to the kernel.

Tensor inputs run on their own device; numpy inputs on
`core.device.resolve_device(device)` (the card unless ``device="cpu"``).
Results are int64 tensors holding u32 values; a 1-D row gives a 0-d tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..core.device import as_tokens, as_u32_values, resolve_device
from ..core.keys import KeyBuffer
from ..core.limbs import hi32
from ..hash.spec import FAMILIES
from . import gf_multihash as gfmh
from . import gf_multilinear as gfk
from . import multihash as mhk
from . import multilinear as mlk

_DISPATCHES = tracing.counter("launch.dispatch", always=True)


def launch_count() -> int:
    return _DISPATCHES.n


def multihash(tokens, keys, lens, *, family="multilinear", mod_m=None,
              width=None, ragged=False):
    """(B, N) int32 tokens x (K, >= W+1) int64 keys -> (B, K, 2) int64 slots.

    See `kernels.ref` for the operand layout and the slot contract.
    `ragged`: the caller gave per-row lengths, so the engine may run the
    rows in length order (`multihash.launch_engine`); the slots are the
    same either way.
    """
    _DISPATCHES.n += 1
    sp = tracing.begin("launch.multihash") if tracing.ON else None
    try:
        if FAMILIES[family].gf:
            return gfmh.gf_multihash(tokens, keys, lens, family=family,
                                     mod_m=mod_m, width=width, ragged=ragged)
        return mhk.multihash(tokens, keys, lens, family=family, mod_m=mod_m,
                             width=width, ragged=ragged)
    finally:
        if sp is not None:
            tracing.end(sp)


def _rows(tokens, device):
    """(tokens as a contiguous (B, N) int32 tensor, whether they were 1-D)."""
    dev = tokens.device if isinstance(tokens, torch.Tensor) else resolve_device(device)
    toks = as_tokens(tokens, dev)
    if toks.dim() not in (1, 2):
        raise ValueError(f"tokens must be (N,) or (B, N), got {tuple(toks.shape)}")
    return toks.reshape(-1, toks.shape[-1]).contiguous(), toks.dim() == 1


def _plane(x, n: int, device) -> torch.Tensor:
    """The first n entries of a u32 key plane (numpy or tensor) as int64
    values on `device`."""
    if len(x) < n:
        raise ValueError(f"key plane has {len(x)} keys; rows of {n - 1} "
                         f"tokens need {n} (m1 first)")
    return as_u32_values(x[:n], device)


def _plane32(x, n: int, device) -> torch.Tensor:
    """The first n entries of a u32 key plane as an int32 tensor of the same
    bits on `device`: a view when x already is one there (so `gf_hash`
    launches nothing but its kernel), else a converted copy."""
    if (isinstance(x, torch.Tensor) and x.device == device and x.dim() == 1
            and x.dtype in (torch.int32, torch.uint32) and len(x) >= n):
        return x[:n].view(torch.int32).contiguous()
    return _plane(x, n, device).to(torch.int32)


def multilinear_hash(tokens, key_hi, key_lo, *, family="multilinear",
                     device=None):
    """Batched (B, N) -> (B,) 32-bit Multilinear(-2x2, -HM) hashes.

    key_hi/key_lo: (>= N+1,) u32 planes (numpy or tensors); key 0 is m1.
    HM hashes floor(N / 2) pairs, as the reference's kernel path does.
    """
    toks, one = _rows(tokens, device)
    n = toks.shape[1] + 1
    keys = (_plane(key_hi, n, toks.device) << 32) | _plane(key_lo, n, toks.device)
    acc = mlk.hash_blocks(toks, keys[1:], family=family)
    out = hi32(((acc[:, 0] << 32) | acc[:, 1]) + keys[0])
    return out[0] if one else out


def gf_hash(tokens, keys32, *, family="gf_multilinear", device=None):
    """Batched (B, N) -> (B,) 32-bit GF(2^32) Multilinear(-HM) hashes:
    Barrett(acc ^ m1) mod p(x). keys32: (>= N+1,) u32 keys; key 0 is m1."""
    toks, one = _rows(tokens, device)
    keys = _plane32(keys32, toks.shape[1] + 1, toks.device)
    out = gfk.gf_hash_rows(toks, keys, family=family)
    return out[0] if one else out


def hash_tokens_batched(tokens, family: str = "multilinear_hm",
                        seed: int = 0x1E53, *, device=None) -> np.ndarray:
    """Convenience: numpy in, (B,) uint32 numpy out, keys from
    `KeyBuffer(seed)`, no variable-length policy (fixed-shape batch)."""
    toks = np.atleast_2d(np.asarray(tokens, np.uint32))
    kb = KeyBuffer(seed=seed)
    hi, lo = kb.hi_lo(toks.shape[1] + 1)
    if family.startswith("gf"):
        out = gf_hash(toks, lo, family=family, device=device)
    else:
        out = multilinear_hash(toks, hi, lo, family=family, device=device)
    return out.cpu().numpy().astype(np.uint32)
