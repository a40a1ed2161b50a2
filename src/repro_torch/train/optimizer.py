"""Hand-rolled optimizers (no `torch.optim`): AdamW and Adafactor.

The port of `repro.train.optimizer`. The update is the reference's,
operation for operation: the clip by the global norm, the schedule and the
bias corrections in f32, the AdamW and Adafactor formulas, and the
``const_`` path filter (hash keys of the hashed embedding and the hash
router are not trainable and pass through untouched).

The parameters are a `models.ParamTree`, updated in place. Everything
else is in the reference's layout, leaf by leaf in its flatten order
(`models.convert.reference_leaves`):

- `grads` is a list with one entry a reference leaf: the port's gradient
  tensors of that leaf (one a block for a stacked leaf), or None for an
  integer leaf (the reference's float0);
- the optimizer state is the reference's nested dict (``{"m", "v"}`` for
  AdamW, ``{"f"}`` for Adafactor), its tensors stacked on the blocks'
  leading axis as the reference stacks them, its ``const_`` leaves the
  parameter's key planes.

Adafactor's statistics are taken over the reference's stacked leaves: a
per-block 1-D leaf (a norm scale, a bias, `A_log`, `D`, `decay`) is a
(n_blocks, d) matrix there, so it is factored with a row statistic per
block and a column statistic across the blocks; the update clip's RMS is
taken over the whole stack. The port stacks each leaf's gradients and
parameters for its update, so its statistics are the reference's.

The schedule's value and the bias corrections are computed in f32 on the
host from the step, a Python int or a 0-d tensor on the CPU (no device
sync); the gradient norm and the clip scale stay on the device.

On a rank of the sharded step (`step.jit_train_step`) the parameters,
gradients and state are the rank's local chunks, and `update` takes
`shards`: the sums that span chunks go through it (the global gradient
norm, which counts each element once, and adafactor's row, column and
update-RMS means over a split dimension); every other operation is
elementwise and runs on the chunks as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..models.convert import reference_leaves

_F32 = torch.float32


def _is_trainable(path: str) -> bool:
    return "const_" not in path


def _nest(pairs) -> dict:
    """{"a/b/c": x, ...} -> {"a": {"b": {"c": x}}, ...}."""
    out: dict = {}
    for path, x in pairs:
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def _get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _rows(t: torch.Tensor, leaf) -> list:
    """A stacked state tensor as the per-block views of a stacked leaf."""
    return list(t.unbind(0)) if leaf.stacked else [t]


def _state_of(leaf, fn) -> Any:
    """State leaf of a parameter leaf: fn(reference shape, device) where
    trainable, else the parameter itself in the reference's layout."""
    t = leaf.tensors[0]
    if _is_trainable(leaf.path):
        return fn(leaf.shape, t.device)
    return torch.stack(leaf.tensors) if leaf.stacked else t


@dataclasses.dataclass(frozen=True)
class Schedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_ratio: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        """The learning rate at `step`: a 0-d f32 tensor on the CPU, in the
        reference's f32 arithmetic."""
        step = torch.as_tensor(step).to("cpu", _F32)
        warm = step / max(self.warmup_steps, 1)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.decay_steps - self.warmup_steps, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        decay = self.min_ratio + (1 - self.min_ratio) * cos
        return self.peak_lr * torch.where(step < self.warmup_steps, warm, decay)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, step, shards=None) -> (params, state, metrics),
    # in place
    update: Callable[..., tuple]


def _floats(grads) -> list:
    return [g for leaf in grads if leaf is not None for g in leaf
            if g.is_floating_point()]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every float gradient (f32), 0-d on
    the gradients' device."""
    ts = [g.float() for g in _floats(grads)]
    return torch.stack(torch._foreach_norm(ts)).square().sum().sqrt()


def _clip_scale(grads, max_norm, shards=None):
    """(min(1, max_norm / norm), norm), 0-d on the gradients' device."""
    norm = global_norm(grads) if shards is None else shards.global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm):
    """-> (grads scaled by min(1, max_norm / norm), norm); None entries
    (integer leaves) pass through."""
    scale, norm = _clip_scale(grads, max_norm)
    return [None if g is None else torch._foreach_mul(g, scale) for g in grads], norm


def _f32_scalar(x) -> torch.Tensor:
    return torch.as_tensor(x).to("cpu", _F32)


def _check(grads, leaves) -> None:
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradient entries for {len(leaves)} "
                         "parameter leaves")


def adamw(schedule: Schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm=1.0) -> Optimizer:
    def init(params):
        zeros = lambda shape, dev: torch.zeros(shape, dtype=_F32, device=dev)  # noqa: E731
        pairs = [(leaf.path, _state_of(leaf, zeros)) for leaf in reference_leaves(params)]
        return {"m": _nest(pairs),
                "v": _nest((p, x.clone() if x.is_floating_point() else x)
                           for p, x in pairs)}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        leaves = reference_leaves(params)
        _check(grads, leaves)
        scale, gnorm = _clip_scale(grads, clip_norm, shards)  # applied leaf by leaf
        lr = schedule(step)
        t = _f32_scalar(step) + 1.0
        bc1 = float(1 - _f32_scalar(b1) ** t)
        bc2 = float(1 - _f32_scalar(b2) ** t)
        lr_f = float(lr)
        for leaf, g in zip(leaves, grads):
            if not _is_trainable(leaf.path):
                continue
            P = leaf.tensors
            M = _rows(_get(state["m"], leaf.path), leaf)
            V = _rows(_get(state["v"], leaf.path), leaf)
            G = torch._foreach_mul([x.float() for x in g], scale)
            # m2 = b1 m + (1 - b1) g;  v2 = b2 v + (1 - b2) g g
            torch._foreach_mul_(M, b1)
            torch._foreach_add_(M, torch._foreach_mul(G, 1 - b1))
            gg = torch._foreach_mul(G, 1 - b2)
            torch._foreach_mul_(gg, G)
            torch._foreach_mul_(V, b2)
            torch._foreach_add_(V, gg)
            del G, gg
            # upd = (m2 / bc1) / (sqrt(v2 / bc2) + eps)
            den = torch._foreach_div(V, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(M, bc1)
            torch._foreach_div_(upd, den)
            del den
            # p2 = p - lr (upd + weight_decay p)
            P32 = [p.float() for p in P]
            torch._foreach_add_(upd, torch._foreach_mul(P32, weight_decay))
            torch._foreach_mul_(upd, lr_f)
            torch._foreach_sub_(P32, upd)
            for p, p2 in zip(P, P32):
                if p2 is not p:
                    p.copy_(p2)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def adafactor(schedule: Schedule, eps=1e-30, clip_threshold=1.0,
              decay_rate=0.8, weight_decay=0.0, clip_norm=1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018), no momentum.
    State per matrix param: one row + one col accumulator -- O(n+m) not O(nm).
    A matrix is a leaf of 2 or more axes in the reference's stacked layout."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def st(shape, dev):
            if _factored(shape):
                return {"vr": torch.zeros(shape[:-1], dtype=_F32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=_F32,
                                          device=dev)}
            return {"v": torch.zeros(shape, dtype=_F32, device=dev)}

        return {"f": _nest((leaf.path, _state_of(leaf, st))
                           for leaf in reference_leaves(params))}

    def upd(p, g, st, beta2, lr, sums=None):
        """One leaf's update; `sums` (a rank's chunk) spans the chunks of
        the means."""
        g = g.float()
        g2 = g * g + eps
        if _factored(p.shape):
            if sums is None:
                r_mean, c_mean = g2.mean(dim=-1), g2.mean(dim=-2)
            else:
                r_mean, c_mean = sums.mean(g2, -1), sums.mean(g2, -2)
            vr = beta2 * st["vr"] + (1 - beta2) * r_mean             # (..., n)
            vc = beta2 * st["vc"] + (1 - beta2) * c_mean             # (..., m)
            vr_mean = (vr.mean(dim=-1, keepdim=True) if sums is None
                       else sums.mean(vr, -1, param_dim=-2, keepdim=True))
            denom = torch.clamp(vr_mean, min=eps)
            # rank-1 reconstruction: v ~ (vr/denom)[..., :, None] * vc[..., None, :]
            u = (g * torch.rsqrt(vr / denom + eps)[..., :, None]
                 * torch.rsqrt(vc + eps)[..., None, :])
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            u = g / torch.sqrt(v + eps)
            new_st = {"v": v}
        # update clipping (RMS <= clip_threshold), over the whole leaf
        rms = torch.sqrt((torch.mean(u * u) if sums is None else sums.mean_all(u * u))
                         + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return p - lr * (u + weight_decay * p.float()), new_st

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        leaves = reference_leaves(params)
        _check(grads, leaves)
        scale, gnorm = _clip_scale(grads, clip_norm, shards)  # applied leaf by leaf
        lr = schedule(step)
        t = _f32_scalar(step) + 1.0
        beta2 = float(1.0 - t ** (-decay_rate))
        for leaf, g in zip(leaves, grads):
            if not _is_trainable(leaf.path):
                continue
            stack = (lambda ts: torch.stack(ts)) if leaf.stacked else (lambda ts: ts[0])
            st = _get(state["f"], leaf.path)
            p2, new_st = upd(stack(leaf.tensors), stack(g) * scale, st, beta2, float(lr),
                             None if shards is None else shards.leaf(leaf.path))
            for k, v in new_st.items():
                st[k].copy_(v)
            for p, row in zip(leaf.tensors, _rows(p2, leaf)):
                p.copy_(row)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def make_optimizer(name: str, schedule: Schedule) -> Optimizer:
    if name == "adamw":
        return adamw(schedule)
    if name == "adafactor":
        return adafactor(schedule)
    raise ValueError(name)
