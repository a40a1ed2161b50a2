"""Train state: step, parameters and optimizer state, and its form in the
reference's layout.

The port of `repro.train.train_state`. `step` is a 0-d int32 tensor held
on the CPU (the optimizer computes the schedule from it on the host, with
no device sync); `params` is the port's `ParamTree` of f32 masters;
`opt_state` is already in the reference's layout (`train.optimizer`).

`to_reference` / `from_reference` convert the whole state to and from the
reference's `TrainState` of nested dicts (blocks stacked, key planes u32):
the form the trainer checkpoints, with the reference's leaf paths, shapes
and dtypes, so either package resumes the other's checkpoints.

`state_shardings` gives the whole state's placements on a mesh (ZeRO: an
optimizer leaf takes its parameter's spec; adafactor's factored `vr`/`vc`
take it truncated, as the reference truncates it), and `shard` one rank's
local part of a whole state under them: the state that the sharded step
(`step.jit_train_step`) and the sharded restore hand each rank.
"""
from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch
from torch import nn

from ..core.device import as_u32_values, resolve_device
from ..core.pytree import flatten_with_paths, map_with_paths
from ..models.convert import as_reference, nested, params_from_jax, reference_layout
from ..models.layers import ParamTree
from ..parallel import sharding as sh


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt_state: Any


def init_state(api, optimizer, gen: torch.Generator) -> TrainState:
    """Fresh f32-master parameters drawn from `gen` (on its device) and
    their optimizer state, at step 0."""
    params = api.init(gen, train=True)
    opt_state = optimizer.init(params)
    return TrainState(torch.zeros((), dtype=torch.int32), params, opt_state)


def _is_key(path: str) -> bool:
    return "const_" in path


def skeleton(state: TrainState) -> TrainState:
    """The reference layout's structure of `state` with the port's own
    tensors in place (stacked leaves as `Stack`s, no copy): the `like` of
    a checkpoint restore."""
    return TrainState(state.step, nested(state.params), state.opt_state)


def to_reference(state: TrainState) -> TrainState:
    """The reference's `TrainState` of `state`: nested dicts of tensors
    where the port's lie, blocks stacked, key planes u32."""
    return TrainState(state.step.detach(), reference_layout(state.params),
                      map_with_paths(lambda _p, x: as_reference(x), state.opt_state))


def copy_to(state: TrainState, device) -> TrainState:
    """A copy of `state` with its parameters and optimizer state on
    `device` (the step stays on the CPU)."""
    return TrainState(state.step.clone(), copy.deepcopy(state.params).to(device),
                      map_with_paths(lambda _p, x: x.to(device, copy=True),
                                     state.opt_state))


def from_reference(cfg, ref: TrainState, device=None) -> TrainState:
    """The port's state on `device` (default: the card) from the
    reference's (numpy or tensor leaves): f32-master parameters, the
    optimizer state as f32 tensors with int64 key planes, the step on the
    CPU."""
    device = resolve_device(device)

    def opt_leaf(path, x):
        if _is_key(path):
            return as_u32_values(x, device)
        return torch.as_tensor(x).to(device=device, dtype=torch.float32, copy=True)

    return TrainState(torch.as_tensor(ref.step).to("cpu", torch.int32),
                      params_from_jax(cfg, ref.params, device, train=True),
                      map_with_paths(opt_leaf, ref.opt_state))


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def stacked_specs(params, mesh, fsdp_pods: bool = False) -> dict:
    """{reference path: spec of the whole leaf} of a parameter tree (a
    port `ParamTree`, or the reference's layout of nested dicts) under
    `mesh`: a stacked leaf's spec has its leading None."""
    with sh.use_mesh(mesh):
        return {path: sh.spec_for(path, sh._shape(x), fsdp_pods)
                for path, x in sh.tree_paths(params)}


def _opt_spec(spec, shape: tuple, pshape: tuple) -> "sh.P":
    """An optimizer leaf's spec from its parameter's (the reference's
    `spec_for_opt`, matched on shapes in its order): the same rank keeps
    the spec; the row statistic drops the last dim, the column statistic
    the second to last; any other shape is replicated."""
    if len(shape) == len(pshape):
        return spec
    dims = list(spec) + [None] * (len(pshape) - len(spec))
    if shape == pshape[:-1]:
        return sh.P(*dims[:-1])
    if shape == pshape[:-2] + pshape[-1:]:
        return sh.P(*(dims[:-2] + dims[-1:]))
    return sh.P()


def _stat_spec(spec, stat: str, ndim: int) -> "sh.P":
    """The spec of adafactor's statistic that follows its parameter's dims:
    the row statistic without the last dim, the column statistic without
    the second to last."""
    dims = list(spec) + [None] * (ndim - len(spec))
    if stat == "vr":
        return sh.P(*dims[:-1])
    if stat == "vc":
        return sh.P(*(dims[:-2] + dims[-1:]))
    return sh.P(*dims)


def opt_specs(opt_state, params, mesh, fsdp_pods: bool = False, by_dims: bool = False):
    """Specs mirroring the optimizer state (the reference's layout):
    AdamW's ``m``/``v`` mirror the parameters; adafactor's ``f`` entries
    take `_opt_spec` of their parameter's -- or, with `by_dims`, the spec
    that follows the parameter's dims (`_stat_spec`; the reference's
    match on shapes gives a square matrix's column statistic the row
    statistic's spec)."""
    specs = stacked_specs(params, mesh, fsdp_pods)
    shapes = {path: sh._shape(x) for path, x in sh.tree_paths(params)}

    def leaf(path, x):
        kind, rest = path.split("/", 1)
        if kind in ("m", "v") or rest in specs:
            return specs[rest]
        owner, stat = rest.rsplit("/", 1)
        if kind != "f" or owner not in specs or stat not in ("v", "vr", "vc"):
            raise ValueError(f"optimizer leaf {path!r} has no parameter")
        if by_dims:
            return _stat_spec(specs[owner], stat, len(shapes[owner]))
        return _opt_spec(specs[owner], tuple(x.shape), shapes[owner])

    return map_with_paths(leaf, opt_state)


def state_shardings(state: TrainState, mesh, fsdp_pods: bool = False) -> TrainState:
    """`NamedSharding`s for the whole state: the step replicated, the
    parameters by `parallel.sharding.param_shardings` (a port `ParamTree`'s
    blocks a `Stack` of per-block shardings), the optimizer state by
    `opt_specs`."""
    return TrainState(
        sh.NamedSharding(mesh, sh.P()),
        sh.param_shardings(state.params, mesh, fsdp_pods),
        map_with_paths(lambda _p, s: sh.NamedSharding(mesh, s),
                       opt_specs(state.opt_state, state.params, mesh, fsdp_pods)))


def map_params(params: ParamTree, fn) -> ParamTree:
    """A new `ParamTree` of `params`' structure whose tensor t of reference
    leaf `leaf` (`models.convert.Leaf`) is fn(leaf, t) (detached); float
    leaves take gradients where `params`' do."""
    from ..models.convert import reference_leaves

    new = {id(t): fn(leaf, t.detach()) for leaf in reference_leaves(params)
           for t in leaf.tensors}

    def walk(m):
        if isinstance(m, nn.ModuleList):
            return [walk(c) for c in m]
        out = {k: new[id(v)] for k, v in {**m._parameters, **m._buffers}.items()}
        out.update({k: walk(v) for k, v in m._modules.items()})
        return out

    return ParamTree(walk(params), trainable=any(p.requires_grad for p in params.parameters()))


def block_sharding(leaf, sharding: "sh.NamedSharding") -> "sh.NamedSharding":
    """A per-block tensor's sharding of a stacked leaf's (the spec without
    its leading None)."""
    if not leaf.stacked:
        return sharding
    return sh.NamedSharding(sharding.mesh, sh.P(*tuple(sharding.spec)[1:]))


def shard(state: TrainState, mesh, rank: int, fsdp_pods: bool = False) -> TrainState:
    """Rank `rank`'s part of a whole `state` under `state_shardings`:
    parameters a `ParamTree` of local chunks, the optimizer state its
    local chunks (copies), the step as it is."""
    specs = stacked_specs(state.params, mesh, fsdp_pods)

    def param(leaf, t):
        s = block_sharding(leaf, sh.NamedSharding(mesh, specs[leaf.path]))
        return s.local(t, rank).clone()

    ops = opt_specs(state.opt_state, state.params, mesh, fsdp_pods)
    flat = dict(flatten_with_paths(ops))
    opt = map_with_paths(
        lambda p, x: sh.NamedSharding(mesh, flat[p]).local(x, rank).clone(),
        state.opt_state)
    return TrainState(state.step.clone(), map_params(state.params, param), opt)
