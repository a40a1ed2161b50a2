"""Distributed-optimization collectives: int8 gradient compression with
error feedback, a hierarchical (pod-aware) reduction, and the counted
collectives of the sharded train step.

The port of `repro.parallel.collectives`' compression: stochastic-rounding
int8 quantization (4x fewer bytes on the wire) with optional error
feedback (Karimireddy et al. 2019). The random bits are the reference's:
leaf i of the flattened gradients (`core.pytree` order) draws
`jax.random.bits(fold_in(key(seed), i), shape, uint32)` in JAX's original
Threefry layout (`quality.keygen`; the reference under
``jax.threefry_partitionable(False)``). A leaf that is not a float tensor
(an integer key plane's place) is counted and passes through.

`hierarchical_psum` is the reference's pod-aware all-reduce: a
reduce-scatter within the inner axis, an all-reduce of the scattered part
across pods, an all-gather within the inner axis, so the cross-pod hop
moves 1/N of the bytes of a flat all-reduce over N inner ranks. It and the
step's collectives (`all_gather_dim`, `reduce_scatter_dim`, `all_reduce`)
run over the named `DeviceMesh` of the live process group
(`parallel.sharding.device_mesh`), each rank passing its own tensor, and
add the bytes each rank sends, by the ring algorithm, to a `traffic` dict
the caller owns, under "<collective>/<axis>": an all-gather sends
(n-1)/n of its output, a reduce-scatter (n-1)/n of its input, an
all-reduce twice that of its tensor, over n ranks.
"""
from __future__ import annotations

import itertools

import torch

from ..core.pytree import flatten_with_paths, map_with_paths
from ..quality.keygen import fold_in, random_bits, seed_key


def quantize_int8(x: torch.Tensor, rng_bits: torch.Tensor, absmax=None):
    """Stochastic-rounding int8 quantization of f32 `x` with u32 `rng_bits`
    (int64 values) of its shape. Returns (q int8, scale 0-d f32). `absmax`:
    the largest magnitude of the whole tensor `x` is a chunk of (default
    `x`'s own)."""
    absmax = (x.abs().max() if absmax is None else absmax) + 1e-12
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


# ---------------------------------------------------------------------------
# counted collectives over the live mesh
# ---------------------------------------------------------------------------

def _count(traffic, op: str, axis: str, nbytes: int, n: int, times: int = 1) -> None:
    if traffic is not None and n > 1:
        key = f"{op}/{axis}"
        traffic[key] = traffic.get(key, 0) + times * nbytes * (n - 1) // n


# PyTorch 2.13 names the one-tensor collectives `all_gather_single` and
# `reduce_scatter_single` and deprecates `all_gather_into_tensor` and
# `reduce_scatter_tensor` (a FutureWarning a call); builds before the
# rename have only the older names.

def _all_gather(out, t, group):
    import torch.distributed as dist

    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(
        out, t, group=group)


def _reduce_scatter(out, t, group):
    import torch.distributed as dist

    (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(
        out, t, group=group)


def _group(dm, axis: str):
    return dm.get_group(axis), dm.size(dm.mesh_dim_names.index(axis))


def all_gather_dim(t: torch.Tensor, dim: int, dm, axis: str, traffic=None) -> torch.Tensor:
    """The ranks' `t` along `axis` concatenated on `dim`, in axis order."""
    import torch.distributed as dist

    group, n = _group(dm, axis)
    if n == 1:
        return t
    out = t.new_empty((n,) + tuple(t.shape))
    _all_gather(out, t.contiguous(), group=group)
    _count(traffic, "all_gather", axis, out.numel() * out.element_size(), n)
    shape = list(t.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape)


def reduce_scatter_dim(t: torch.Tensor, dim: int, dm, axis: str, traffic=None) -> torch.Tensor:
    """The sum over the ranks along `axis` of `t`, split on `dim` into one
    equal chunk a rank, in axis order: this rank's chunk."""
    import torch.distributed as dist

    group, n = _group(dm, axis)
    if n == 1:
        return t
    inp = t.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // n,) + tuple(inp.shape[1:]))
    _reduce_scatter(out, inp, group=group)
    _count(traffic, "reduce_scatter", axis, inp.numel() * inp.element_size(), n)
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, dm, axis: str, traffic=None, op=None) -> torch.Tensor:
    """The sum (or `op`: a `ReduceOp`) over the ranks along `axis` of `t`,
    in place."""
    import torch.distributed as dist

    group, n = _group(dm, axis)
    if n > 1:
        dist.all_reduce(t, group=group, op=dist.ReduceOp.SUM if op is None else op)
        _count(traffic, "all_reduce", axis, t.numel() * t.element_size(), n, times=2)
    return t


def hierarchical_psum(x: torch.Tensor, mesh, *, pod_axis: str = "pod",
                      inner_axis: str = "data", traffic=None) -> torch.Tensor:
    """Pod-aware all-reduce of this rank's local shard `x`: the sum over
    every (pod, inner) coordinate of their shards, replicated. Without the
    pod axis, an all-reduce over the inner axis; with it, a reduce-scatter
    within the inner axis (on `x`'s leading dim, which its size must
    divide), an all-reduce of the scattered part across pods, and an
    all-gather within the inner axis. Runs on the live process group
    (`parallel.sharding.device_mesh(mesh)`)."""
    from .sharding import device_mesh

    dm = device_mesh(mesh)
    if pod_axis not in mesh.axis_names:
        return all_reduce(x.clone(), dm, inner_axis, traffic)
    n = mesh.shape[inner_axis]
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not split over "
                         f"{inner_axis} ({n} ranks)")
    part = reduce_scatter_dim(x, 0, dm, inner_axis, traffic)
    part = all_reduce(part, dm, pod_axis, traffic)
    return all_gather_dim(part, 0, dm, inner_axis, traffic)


def world_sum(t: torch.Tensor, traffic=None) -> torch.Tensor:
    """The sum over every rank of the live process group of `t`, in place."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n > 1:
        dist.all_reduce(t)
        _count(traffic, "all_reduce", "world", t.numel() * t.element_size(), n, times=2)
    return t
