"""Sharded prefill and decode: the serving cells of the dry run, and
tensor-parallel serving on a world of ranks.

The reference gets its sharded serving from `jax.jit` with `in_shardings`
(`repro.launch.dryrun.build_cell`) and the models' `constraint` calls:
bf16 weights at the serving rules (`param_specs(serving=True)`: the model
axis holds the shards, no FSDP dim; the MoE experts' F over "data"), the
caches at `cache_shardings` (long-context when B = 1), the tokens at
`batch_sharding`; a prefill's residual stream split along the sequence
over "model" with context-parallel attention, a decode step's attention
flash-decoding over the caches' chunks of positions. Here every rank of
the live process group (`parallel.local_world`'s threads,
`parallel.fake_world`, or one process a rank) holds plain tensors -- its
chunks of the weights (`shard_params`), its batch rows (`Layout.rows`),
its chunks of the caches -- and runs the models' own prefill and decode
on its `parallel.partition.ServingPartition` (`Layout.partition`), which
writes that program out with explicit collectives. The values are the
single-device model's.
"""
from __future__ import annotations

import torch

from ..parallel import sharding as sh
from ..parallel.partition import ServingPartition, row_parts
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
    """A whole `ParamTree` -> rank `rank`'s tree of its chunks at the
    serving placements (copies, so the whole tree can be freed); float
    leaves cast to `dtype` when given."""
    shardings = serving_shardings(params, mesh)

    def leaf(lf, t):
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return _block(lf, shardings[lf.path]).local(t, rank).clone()

    return map_params(params, leaf)


def local_params(params, mesh, dtype=None, device=None):
    """Like `shard_params`, with each chunk a fresh tensor of zeros of the
    chunk's shape on `device` (default the leaf's): only `params`' shapes
    are read (the dry run's arguments)."""
    shardings = serving_shardings(params, mesh)

    def leaf(lf, t):
        s = _block(lf, shardings[lf.path])
        dt = dtype if dtype is not None and t.is_floating_point() else t.dtype
        return torch.zeros(s.local_shape(t.shape), dtype=dt,
                           device=t.device if device is None else device)

    return map_params(params, leaf)


class Layout:
    """B rows served into caches of S positions on `mesh`: the rows split
    over the batch axes (`batch_sharding`) when those divide B, else every
    rank holds them all; the caches long-context when B = 1."""

    def __init__(self, mesh, B: int, S: int):
        self.mesh, self.B, self.S = mesh, int(B), int(S)
        self.nb = row_parts(mesh, self.B)

    def rows(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank `rank`'s rows of a whole batch tensor (dim 0)."""
        if self.nb == 1:
            return x
        return sh.batch_sharding(self.mesh, x.ndim).local(x, rank)

    def partition(self, params=None, gather: bool = False) -> ServingPartition:
        """This rank's `ServingPartition` (the live process group's rank).
        With `gather`, its plan gathers the chunks of `params` that the
        serving rules split over the batch axes (the MoE experts' F, for a
        prefill's groups of the rank's rows), in their own dtype."""
        import torch.distributed as dist

        from ..models.convert import reference_leaves

        plans = {}
        if gather and params is not None:
            shardings = serving_shardings(params, self.mesh)
            for leaf in reference_leaves(params):
                s = _block(leaf, shardings[leaf.path])
                for t in leaf.tensors:
                    axes = [(d, a) for d, names in enumerate(s._dim_axes(t.ndim))
                            for a in reversed(names) if a != "model"]
                    if axes and t.is_floating_point():
                        plans[id(t)] = (axes, [], t.dtype)
        return ServingPartition(self.mesh, dist.get_rank(), sh.device_mesh(self.mesh),
                                self.B, self.S, plans)


def _groups(layout: Layout, moe_groups: int) -> int:
    """The MoE groups of the rank's rows, of `moe_groups` over the global
    batch."""
    if moe_groups % layout.nb:
        raise ValueError(f"moe_groups {moe_groups} is not a multiple of the "
                         f"{layout.nb} batch ranks")
    return moe_groups // layout.nb


def prefill(api, params, batch: dict, layout: Layout, moe_groups: int = 1):
    """`api.prefill` of this rank: its chunks of the weights (`shard_params`
    or `local_params`), its rows of the batch (`layout.rows`) -> (logits
    (rows, V), its chunks of the caches of `layout.S` positions)."""
    part = layout.partition(params, gather=True)
    return api.prefill(params, batch, cache_len=layout.S,
                       moe_groups=_groups(layout, moe_groups), part=part)


def decode_step(api, params, caches, token, pos: int, layout: Layout, moe_groups: int = 1):
    """`api.decode_step` of this rank -> (logits (rows, V), caches), its
    chunks of the caches written in place."""
    return api.decode_step(params, caches, token, int(pos),
                           moe_groups=_groups(layout, moe_groups),
                           part=layout.partition())
