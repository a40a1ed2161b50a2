"""Train step factory: loss, gradients and the optimizer, with optional
microbatch gradient accumulation and int8 compression of the gradients.

The port of `repro.train.step`. The step runs eagerly on the parameters'
device and updates the state in place (the reference's is a pure function
that its caller jits).

`jit_train_step` is the step of one rank of a mesh, over the live process
group (`parallel.local_world`'s threaded ranks, or one process a rank):
the state arrives and leaves as the rank's chunks under
`train_state.state_shardings`, the batch as its shard over the batch axes
(`parallel.sharding.batch_sharding`). Its schedule is ZeRO-3's: gather the
parameters, run `gradients` on the local batch, average the gradients
over the batch ranks and reduce-scatter them into the parameters'
placements, run the optimizer on the local chunks. The "model" ranks
compute the same gradients redundantly: there is no tensor-parallel
compute yet, a difference of schedule from the reference's, not of value.
"""
from __future__ import annotations

import math

import torch

from ..models.convert import reference_leaves
from ..parallel import sharding as sh
from .optimizer import Optimizer
from ..core.pytree import flatten_with_paths, map_with_paths
from .train_state import (TrainState, block_sharding, copy_to, map_params,
                          opt_specs, stacked_specs)


def _split(batch: dict, grad_accum: int, i: int) -> dict:
    """Microbatch i of grad_accum equal splits of every value's axis 0."""
    def part(x):
        B = x.shape[0]
        return x.reshape(grad_accum, B // grad_accum, *x.shape[1:])[i]
    return {k: part(v) for k, v in batch.items()}


def gradients(api, params, batch, *, moe_groups: int = 1, grad_accum: int = 1,
              objective=None):
    """-> (loss, metrics, grads): grads a list, one entry a reference leaf
    (`models.convert.reference_leaves`): the f32 gradients of its per-block
    tensors, or None for a key plane; the form the optimizer takes. With
    `grad_accum`, the mean over that many equal microbatches; the metrics
    are the last microbatch's, as the reference's `scan` gives them. With
    `objective`, objective(loss, metrics) is what is differentiated and
    returned as the loss."""
    leaves = reference_leaves(params)
    trained = [t for leaf in leaves for t in leaf.tensors if t.requires_grad]
    if not trained:
        raise ValueError("the parameters take no gradient: build them "
                         "with api.init(gen, train=True) or init_state")
    acc, loss_sum = None, 0.0
    for i in range(grad_accum):
        mb = batch if grad_accum == 1 else _split(batch, grad_accum, i)
        loss, metrics = api.loss(params, mb, moe_groups=moe_groups)
        if objective is not None:
            loss = objective(loss, metrics)
        gs = [g.float() for g in torch.autograd.grad(loss, trained)]
        if acc is None:
            acc = gs
        else:
            torch._foreach_add_(acc, gs)
        loss_sum = loss_sum + loss.detach()
    if grad_accum > 1:
        torch._foreach_mul_(acc, 1.0 / grad_accum)
        loss_sum = loss_sum * (1.0 / grad_accum)
    it = iter(acc)
    grads = [[next(it) for _ in leaf.tensors] if leaf.tensors[0].requires_grad
             else None for leaf in leaves]
    return loss_sum, {k: v.detach() for k, v in metrics.items()}, grads


def reference_grads(api, params, batch, **kw) -> tuple:
    """-> (loss, {path: gradient}): every float leaf's f32 gradient in the
    reference's shape (a stacked leaf's blocks first), as the reference's
    `jax.value_and_grad` gives it. `kw` as `gradients`."""
    loss, _, grads = gradients(api, params, batch, **kw)
    return loss, {leaf.path: torch.stack(g) if leaf.stacked else g[0]
                  for leaf, g in zip(reference_leaves(params), grads) if g is not None}


class TrainStep:
    """step(state, batch) -> (state, metrics), with the metrics the
    reference's: ce, balance, loss, grad_norm, lr (0-d tensors). Its
    settings stay readable (`jit_train_step` runs them on a mesh)."""

    def __init__(self, api, optimizer: Optimizer, moe_groups: int,
                 grad_accum: int, compress_pod_grads: bool):
        self.api, self.optimizer = api, optimizer
        self.moe_groups, self.grad_accum = moe_groups, grad_accum
        self.compress_pod_grads = compress_pod_grads

    def __call__(self, state: TrainState, batch):
        loss, metrics, grads = gradients(self.api, state.params, batch,
                                         moe_groups=self.moe_groups,
                                         grad_accum=self.grad_accum)
        if self.compress_pod_grads:
            grads = _compressed(reference_leaves(state.params), grads)
        params, opt_state, opt_metrics = self.optimizer.update(
            grads, state.opt_state, state.params, state.step)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(state.step + 1, params, opt_state), metrics


def make_train_step(api, optimizer: Optimizer, *, moe_groups: int = 1,
                    grad_accum: int = 1, compress_pod_grads: bool = False) -> TrainStep:
    """-> step(state, batch) -> (state, metrics) (a `TrainStep`)."""
    return TrainStep(api, optimizer, moe_groups, grad_accum, compress_pod_grads)


def _compressed(leaves, grads) -> list:
    """`compress_grads_int8` over the reference's flattened gradients: a
    stacked leaf is stacked (one scale, one draw of bits), an integer leaf
    is counted and passes through (the reference's float0 leaf raises
    there)."""
    from ..parallel.collectives import compress_grads_int8

    flat = [leaf.tensors[0] if g is None else
            torch.stack(g) if leaf.stacked else g[0]
            for leaf, g in zip(leaves, grads)]
    out = compress_grads_int8(flat)
    return [None if g is None else list(o.unbind(0)) if leaf.stacked else [o]
            for leaf, g, o in zip(leaves, grads, out)]


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

class _LeafSums:
    """Means over the chunks of one leaf (stacked layout) on this rank: a
    local sum, then an all-reduce over the mesh axes that split the
    dimension."""

    def __init__(self, sharding, ndim: int, dm, traffic):
        self.axes = sharding._dim_axes(ndim)
        self.mesh, self.dm, self.traffic = sharding.mesh, dm, traffic

    def _sum(self, s: torch.Tensor, axes) -> torch.Tensor:
        from ..parallel.collectives import all_reduce

        for a in axes:
            all_reduce(s, self.dm, a, self.traffic)
        return s

    def mean(self, t: torch.Tensor, dim: int, param_dim: int | None = None,
             keepdim: bool = False) -> torch.Tensor:
        """Mean over `dim` of `t`, whose `dim` is the leaf's `param_dim`
        (default the same), across its chunks."""
        axes = self.axes[dim if param_dim is None else param_dim]
        parts = sh._axis_size(self.mesh, axes) if axes else 1
        return self._sum(t.sum(dim=dim, keepdim=keepdim), axes) / (t.shape[dim] * parts)

    def mean_all(self, t: torch.Tensor) -> torch.Tensor:
        axes = [a for dim_axes in self.axes for a in dim_axes]
        parts = sh._axis_size(self.mesh, axes) if axes else 1
        return self._sum(t.sum(), axes) / (t.numel() * parts)


class _Shards:
    """The optimizer's view of one rank's chunks (`Optimizer.update`'s
    `shards`)."""

    def __init__(self, shardings: dict, dm, traffic):
        self.shardings, self.dm, self.traffic = shardings, dm, traffic

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient element, each
        counted once: a chunk's squares over its replicas, summed over the
        world."""
        from ..parallel.collectives import world_sum

        parts = []
        for (path, s), g in zip(self.shardings.items(), grads):
            if g is None:
                continue
            sq = torch.stack(torch._foreach_norm([x.float() for x in g])).square().sum()
            parts.append(sq / s.replicas(len(s.spec)))
        total = torch.stack(parts).sum()
        return world_sum(total, self.traffic).sqrt()

    def leaf(self, path: str) -> _LeafSums:
        s = self.shardings[path]
        return _LeafSums(s, len(s.spec), self.dm, self.traffic)


def _reduce_grad(g: torch.Tensor, sharding, coords: dict, batch: tuple, dm, traffic):
    """The sum over the batch ranks of each rank's full gradient `g`,
    as this rank's chunk under `sharding`: an all-reduce over the batch
    axes the layout does not split, a reduce-scatter over those it does,
    and the rank's slice along the others (whose ranks computed the same
    gradient)."""
    from ..parallel.collectives import all_reduce, reduce_scatter_dim

    dim_axes = sharding._dim_axes(g.ndim)
    used = {a for axes in dim_axes for a in axes}
    for a in batch:
        if a not in used:
            g = all_reduce(g, dm, a, traffic)
    for d, axes in enumerate(dim_axes):
        for a in axes:
            if a in batch:
                g = reduce_scatter_dim(g, d, dm, a, traffic)
            else:
                c = g.shape[d] // sharding.mesh.shape[a]
                g = g.narrow(d, coords[a] * c, c)
    return g


def _local_chunk(g: torch.Tensor, sharding, coords: dict) -> torch.Tensor:
    """This rank's chunk of a whole tensor (no communication)."""
    dim_axes = sharding._dim_axes(g.ndim)
    for d, axes in enumerate(dim_axes):
        for a in axes:
            c = g.shape[d] // sharding.mesh.shape[a]
            g = g.narrow(d, coords[a] * c, c)
    return g


def _has_moe(api) -> bool:
    return bool(getattr(api.cfg, "n_experts", 0))


def jit_train_step(step_fn: TrainStep, mesh, state: TrainState, batch_ndim_tree,
                   fsdp_pods: bool = False, donate: bool = True):
    """-> sharded(local_state, local_batch) -> (local_state, metrics), run by
    every rank of the live process group (one rank a position of `mesh`).

    `state` (whole, or any state of the same paths and whole shapes) fixes
    the placements: `train_state.state_shardings(state, mesh, fsdp_pods)`;
    each rank passes its part (`train_state.shard`) and gets its updated
    part back, updated in place unless `donate` is False. The batch is the
    rank's shard of each entry of `batch_ndim_tree` (name -> ndim) under
    `batch_sharding`: its rows of the global batch. `step_fn` is a
    `make_train_step` step; its `moe_groups` counts the global batch's MoE
    groups, which must be a multiple of the batch ranks for a model with
    experts (a group is then some of one rank's tokens). Its `grad_accum`
    must be 1: the single-device step splits the global batch into
    microbatches, and splitting each rank's rows instead would give other
    MoE groups and other token sets to average over. The metrics are
    the global ones (the loss a mean over all tokens, balance statistics
    over the global batch through `parallel.sharding.batch_mean`) plus
    ``traffic``: {"<collective>/<axis>": bytes this rank sent}."""
    import torch.distributed as dist

    from ..parallel.collectives import all_gather_dim, all_reduce

    if not isinstance(step_fn, TrainStep):
        raise TypeError("jit_train_step takes a make_train_step step")
    if step_fn.grad_accum != 1:
        raise ValueError(f"grad_accum {step_fn.grad_accum}: the sharded step takes "
                         "no microbatches")
    specs = stacked_specs(state.params, mesh, fsdp_pods)
    shardings = {p: sh.NamedSharding(mesh, s) for p, s in specs.items()}
    # optimizer leaves held in a layout other than the one their update
    # works in (adafactor's column statistic of a square matrix): path ->
    # (held, worked)
    held = dict(flatten_with_paths(opt_specs(state.opt_state, state.params, mesh,
                                             fsdp_pods)))
    worked = dict(flatten_with_paths(opt_specs(state.opt_state, state.params, mesh,
                                               fsdp_pods, by_dims=True)))
    moved = {p: (sh.NamedSharding(mesh, held[p]), sh.NamedSharding(mesh, worked[p]))
             for p in held if tuple(held[p]) != tuple(worked[p])}
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_batch = math.prod(mesh.shape[a] for a in batch_axes)
    groups = step_fn.moe_groups
    if _has_moe(step_fn.api):
        if groups % n_batch:
            raise ValueError(f"moe_groups {groups} is not a multiple of the "
                             f"{n_batch} batch ranks")
        groups //= n_batch
    for name, nd in dict(batch_ndim_tree).items():
        if nd < 1:
            raise ValueError(f"batch entry {name!r} has no batch dim")

    def placed(leaf):
        return block_sharding(leaf, shardings[leaf.path])

    def sharded(local: TrainState, batch: dict):
        dm = sh.device_mesh(mesh)
        coords = mesh.coords(dist.get_rank())
        traffic: dict = {}
        if not donate:
            local = copy_to(local, next(iter(local.params.parameters())).device)

        def whole(t, s):
            for d, axes in enumerate(s._dim_axes(t.ndim)):
                for a in reversed(axes):
                    t = all_gather_dim(t, d, dm, a, traffic)
            return t

        def gather(leaf, t):
            return whole(t, placed(leaf))

        def relaid(path, t, src, dst):
            return _local_chunk(whole(t, src), dst, coords).clone()

        # a backward on the rank's own thread, where its process group and
        # mesh are (a recompute may take part in a collective)
        with sh.use_mesh(mesh), torch.autograd.set_multithreading_enabled(False):
            full = map_params(local.params, gather)
            w = _token_weight(batch, dm, batch_axes, n_batch, traffic, mesh.devices[0])
            objective = None if w == 1.0 else (
                lambda loss, metrics: loss + (w - 1.0) * metrics["ce"])
            loss, metrics, grads = gradients(step_fn.api, full, batch, moe_groups=groups,
                                             objective=objective)
            leaves = reference_leaves(local.params)
            if step_fn.compress_pod_grads:
                # the reference compresses the whole averaged gradient
                for g in grads:
                    for x in g or ():
                        for a in batch_axes:
                            all_reduce(x, dm, a, traffic)
                        x.div_(n_batch)
                grads = _compressed(reference_leaves(full), grads)
                local_grads = [None if g is None else
                               [_local_chunk(x, placed(leaf), coords).contiguous() for x in g]
                               for leaf, g in zip(leaves, grads)]
            else:
                local_grads = [None if g is None else
                               [_reduce_grad(x, placed(leaf), coords, batch_axes, dm,
                                             traffic).div_(n_batch) for x in g]
                               for leaf, g in zip(leaves, grads)]
            del full, grads
            work = map_with_paths(
                lambda p, t: relaid(p, t, *moved[p]) if p in moved else t, local.opt_state)
            params, work, opt_metrics = step_fn.optimizer.update(
                local_grads, work, local.params, local.step,
                shards=_Shards(shardings, dm, traffic))
            out = dict(flatten_with_paths(work))
            for p, t in flatten_with_paths(local.opt_state):
                if p in moved:
                    t.copy_(relaid(p, out[p], *moved[p][::-1]))
            stats = torch.stack([loss.detach().float(), w * metrics["ce"].float(),
                                 metrics["balance"].float()])
            for a in batch_axes:
                all_reduce(stats, dm, a, traffic)
            stats /= n_batch
        metrics = dict(metrics, ce=stats[1], balance=stats[2], loss=stats[0],
                       **opt_metrics, traffic=traffic)
        return TrainState(local.step + 1, params, local.opt_state), metrics

    return sharded


def _token_weight(batch: dict, dm, batch_axes, n_batch, traffic, device) -> float:
    """The weight of this rank's CE that makes the ranks' averaged
    gradients those of the global mean over tokens: with a mask whose
    token counts differ across the ranks, count_r * n_batch / count; 1
    without."""
    from ..parallel.collectives import all_reduce

    mask = batch.get("mask")
    if mask is None:
        return 1.0
    counts = torch.zeros(n_batch, dtype=torch.float64, device=device)
    local = torch.as_tensor(mask).to(device).double().sum()
    idx = 0
    for a in batch_axes:
        idx = idx * dm.size(dm.mesh_dim_names.index(a)) + dm.get_local_rank(a)
    counts[idx] = local
    for a in batch_axes:
        all_reduce(counts, dm, a, traffic)
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(counts):
        # a fake world (the dry run) holds no counts: equal counts, as
        # a packed batch's mask of ones gives them
        return 1.0
    if bool((counts == counts[0]).all()):
        return 1.0
    return float(local * n_batch / counts.sum().clamp_min(1))
