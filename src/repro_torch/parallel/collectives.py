"""Distributed-optimization collectives: int8 gradient compression with
error feedback.

The port of `repro.parallel.collectives`' compression: stochastic-rounding
int8 quantization (4x fewer bytes on the wire) with optional error
feedback (Karimireddy et al. 2019). The random bits are the reference's:
leaf i of the flattened gradients (`core.pytree` order) draws
`jax.random.bits(fold_in(key(seed), i), shape, uint32)` in JAX's original
Threefry layout (`quality.keygen`; the reference under
``jax.threefry_partitionable(False)``). A leaf that is not a float tensor
(an integer key plane's place) is counted and passes through.

`hierarchical_psum` (a pod-aware reduce over a device mesh) waits for the
port of `parallel/`'s mesh and process groups (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import itertools

import torch

from ..core.pytree import flatten_with_paths, map_with_paths
from ..quality.keygen import fold_in, random_bits, seed_key


def quantize_int8(x: torch.Tensor, rng_bits: torch.Tensor):
    """Stochastic-rounding int8 quantization of f32 `x` with u32 `rng_bits`
    (int64 values) of its shape. Returns (q int8, scale 0-d f32)."""
    absmax = x.abs().max() + 1e-12
    scale = absmax / 127.0
    y = x / scale
    floor = torch.floor(y)
    frac = y - floor
    rnd = rng_bits.to(torch.float32) / 2.0 ** 32
    q = (floor + (rnd < frac)).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _bits(key, i: int, g: torch.Tensor) -> torch.Tensor:
    return random_bits(fold_in(key, i), tuple(g.shape), g.device)


def _is_float(g) -> bool:
    return isinstance(g, torch.Tensor) and g.is_floating_point()


def compress_grads_int8(grads, seed: int = 0):
    """Quantize -> dequantize each float gradient leaf (the compressed wire
    format, simulated in place of the cross-pod reduce)."""
    key, index = seed_key(seed), itertools.count()

    def leaf(_path, g):
        i = next(index)  # map_with_paths visits the leaves in flatten order
        if not _is_float(g):
            return g
        q, scale = quantize_int8(g.float(), _bits(key, i, g))
        return dequantize_int8(q, scale).to(g.dtype)

    return map_with_paths(leaf, grads)


def error_feedback_compress(grads, residual, seed: int = 0):
    """Compression with error feedback: q = Q(g + r); r' = (g + r) - q.
    Returns (compressed grads, new residual), each shaped as `grads`."""
    key, index = seed_key(seed), itertools.count()
    old = iter([r for _, r in flatten_with_paths(residual)])
    new = []

    def leaf(_path, g):
        i, r = next(index), next(old)
        if not _is_float(g):
            new.append(r)
            return g
        tot = g.float() + r
        q, scale = quantize_int8(tot, _bits(key, i, g))
        dq = dequantize_int8(q, scale)
        new.append(tot - dq)
        return dq.to(g.dtype)

    out = map_with_paths(leaf, grads)
    new_it = iter(new)
    return out, map_with_paths(lambda _p, _g: next(new_it), grads)
