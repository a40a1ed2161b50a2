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
`state_shardings` waits for the port of `parallel/sharding.py`'s
parameter specs (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch

from ..core.device import as_u32_values, resolve_device
from ..core.pytree import map_with_paths
from ..models.convert import as_reference, nested, params_from_jax, reference_layout


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
