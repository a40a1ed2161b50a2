"""Sharded prefill and decode: the serving cells of the dry run, and
tensor-parallel serving on a world of ranks.

The reference gets its sharded serving from `jax.jit` with `in_shardings`
(`repro.launch.dryrun.build_cell`): bf16 weights at the serving rules
(`param_specs(serving=True)`: the model axis holds the shards, no FSDP
dim), the caches at `cache_shardings` (long-context when B = 1), the
tokens at `batch_sharding`. Here every rank of the live process group
(`parallel.local_world`'s threads, `parallel.fake_world`, or one process a
rank) holds DTensors at those placements, and the model runs on them under
`implicit_replication` (a plain tensor the model makes -- positions, masks,
zeros -- counts as replicated): DTensor's propagation decides each op's
communication. The caches are made at their placements (`init_caches`
under a live mesh), written where a rank's chunk holds the position
(`parallel.sharding.write_at`), and the MoE layers route each rank's own
groups (`models.moe`). The values are the single-device model's.
"""
from __future__ import annotations

import contextlib

import torch

from ..parallel import sharding as sh
from ..train.train_state import map_params


def serving_shardings(params, mesh) -> dict:
    """{reference path: `NamedSharding` of the whole (stacked) leaf} under
    the serving rules."""
    with sh.use_mesh(mesh):
        return {path: sh.NamedSharding(mesh, sh.spec_for(path, sh._shape(x),
                                                         serving=True))
                for path, x in sh.tree_paths(params)}


def _block(leaf, s: "sh.NamedSharding") -> "sh.NamedSharding":
    return sh.NamedSharding(s.mesh, sh.P(*tuple(s.spec)[1:])) if leaf.stacked else s


def shard_params(params, mesh, rank: int, dtype=None):
    """A whole `ParamTree` held by every rank -> this rank's tree of
    DTensors at the serving placements (its chunks are slices: no
    communication); float leaves cast to `dtype` when given."""
    shardings = serving_shardings(params, mesh)

    def leaf(lf, t):
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return sh.distribute(t, _block(lf, shardings[lf.path]), rank)

    return map_params(params, leaf)


def local_params(params, mesh, dtype=None, device=None):
    """Like `shard_params`, with each chunk a fresh tensor of zeros of the
    chunk's shape on `device` (default the leaf's): no whole tensor behind
    it and no values, only `params`' shapes are read (the dry run's
    arguments)."""
    shardings = serving_shardings(params, mesh)

    def leaf(lf, t):
        s = _block(lf, shardings[lf.path])
        dt = dtype if dtype is not None and t.is_floating_point() else t.dtype
        local = torch.zeros(s.local_shape(t.shape), dtype=dt,
                            device=t.device if device is None else device)
        return sh.dtensor(local, s, t.shape)

    return map_params(params, leaf)


def shard_batch(x: torch.Tensor, mesh, rank: int) -> torch.Tensor:
    """A whole batch tensor -> this rank's DTensor at `batch_sharding`."""
    return sh.distribute(x, sh.batch_sharding(mesh, x.ndim), rank)


def replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """A whole tensor every rank holds, as a replicated DTensor."""
    return sh.dtensor(x, sh.NamedSharding(mesh, sh.P()), x.shape)


@contextlib.contextmanager
def _serving():
    from torch.distributed.tensor.experimental import implicit_replication

    with torch.no_grad(), implicit_replication():
        yield


def prefill(api, params, batch: dict, cache_len=None, moe_groups: int = 1):
    """`api.prefill` over DTensor weights and batch (the rank's part of
    the sharded program) -> (logits DTensor (B, V), caches of DTensors)."""
    with _serving():
        return api.prefill(params, batch, cache_len=cache_len, moe_groups=moe_groups)


def decode_step(api, params, caches, token, pos: int, moe_groups: int = 1):
    """`api.decode_step` over DTensors -> (logits DTensor (B, V), caches),
    the caches written in place."""
    with _serving():
        return api.decode_step(params, caches, token, int(pos), moe_groups=moe_groups)
