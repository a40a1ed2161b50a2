"""Train step factory: loss, gradients and the optimizer, with optional
microbatch gradient accumulation and int8 compression of the gradients.

The port of `repro.train.step`. The step runs eagerly on the parameters'
device and updates the state in place (the reference's is a pure function
that its caller jits). `jit_train_step` (explicit shardings for the
production mesh) waits for the port of `parallel/` (ROADMAP Queue 1
item 7).
"""
from __future__ import annotations

import torch

from ..models.convert import reference_leaves
from .optimizer import Optimizer
from .train_state import TrainState


def _split(batch: dict, grad_accum: int, i: int) -> dict:
    """Microbatch i of grad_accum equal splits of every value's axis 0."""
    def part(x):
        B = x.shape[0]
        return x.reshape(grad_accum, B // grad_accum, *x.shape[1:])[i]
    return {k: part(v) for k, v in batch.items()}


def gradients(api, params, batch, *, moe_groups: int = 1, grad_accum: int = 1):
    """-> (loss, metrics, grads): grads a list, one entry a reference leaf
    (`models.convert.reference_leaves`): the f32 gradients of its per-block
    tensors, or None for a key plane; the form the optimizer takes. With
    `grad_accum`, the mean over that many equal microbatches; the metrics
    are the last microbatch's, as the reference's `scan` gives them."""
    leaves = reference_leaves(params)
    trained = [t for leaf in leaves for t in leaf.tensors if t.requires_grad]
    if not trained:
        raise ValueError("the parameters take no gradient: build them "
                         "with api.init(gen, train=True) or init_state")
    acc, loss_sum = None, 0.0
    for i in range(grad_accum):
        mb = batch if grad_accum == 1 else _split(batch, grad_accum, i)
        loss, metrics = api.loss(params, mb, moe_groups=moe_groups)
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


def make_train_step(api, optimizer: Optimizer, *, moe_groups: int = 1,
                    grad_accum: int = 1, compress_pod_grads: bool = False):
    """-> step(state, batch) -> (state, metrics), with the metrics the
    reference's: ce, balance, loss, grad_norm, lr (0-d tensors)."""

    def step(state: TrainState, batch):
        loss, metrics, grads = gradients(api, state.params, batch,
                                         moe_groups=moe_groups, grad_accum=grad_accum)
        if compress_pod_grads:
            grads = _compressed(reference_leaves(state.params), grads)
        params, opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params, state.step)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(state.step + 1, params, opt_state), metrics

    return step


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
