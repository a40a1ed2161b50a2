"""The control and the faults of a training cell, planted under the timed
path for the length of a `with plant(kind):` block, so that the harness
and the runner (`runners/train_step.py`) run unchanged above them:

- control: the reference (`reference/lm.py`) in the program's place, one
  step below the configuration's bf16: its products' operands in float8
  (per-tensor scales, e4m3 forward, e5m2 gradients);
- stale: the step computes its gradients and returns the state unchanged;
- half: the step trains on the first half of the batch's rows, the mean
  taken over them;
- expert: one routed expert's output (expert `EXPERT`) zeroed in the
  middle layer;
- layer: the middle layer's attention output left out;
- flip: each step's update applied with its sign flipped;
- swap: the gradients of two experts (`EXPERT` and the next) exchanged in
  the middle layer's up projection.
"""
from __future__ import annotations

import contextlib
import sys

import torch

from hashbench.harness import ROOT
from hashbench.reference import lm
from hashbench.runners import train_step

KINDS = ("control", "stale", "half", "expert", "layer", "flip", "swap")
EXPERT = 0


@contextlib.contextmanager
def plant(kind: str):
    """Within the block, the training cell's program carries `kind`."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; have {KINDS}")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.models import attention, moe
    from repro_torch.models.convert import reference_leaves
    from repro_torch.train import step

    saved, target = [], {}

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    sound_open, sound_call = train_step.open_program, step.TrainStep.__call__
    sound_experts, sound_attend = moe._experts, attention.attend
    sound_gradients = step.gradients

    def reference(cfg, weights, device):
        return lm.Trainer(lm.Arch.of(cfg), weights, cfg["optimizer"], cfg["schedule"],
                          precision="fp8")

    def opened(cfg, weights, device):
        prog = sound_open(cfg, weights, device)
        blocks = prog.state.params["blocks"]
        target["block"] = blocks[len(blocks) // 2]["s0"]
        return prog

    def stale(self, state, batch):
        loss, metrics, _ = step.gradients(self.api, state.params, batch,
                                          moe_groups=self.moe_groups,
                                          grad_accum=self.grad_accum)
        return step.TrainState(state.step + 1, state.params, state.opt_state), \
            dict(metrics, loss=loss)

    def half(self, state, batch):
        n = batch["tokens"].shape[0] // 2
        return sound_call(self, state, {k: v[:n] for k, v in batch.items()})

    def experts(params, buf, T, act, dtype):
        out = sound_experts(params, buf, T, act, dtype)
        if params["w_up"]["w"] is target["block"]["moe"]["w_up"]["w"]:
            keep = torch.ones(out.shape[1], dtype=out.dtype, device=out.device)
            keep[EXPERT] = 0
            out = out * keep[None, :, None, None]
        return out

    def attend(params, hq, hkv, **kw):
        o, kind_ = sound_attend(params, hq, hkv, **kw)
        if params["wq"]["w"] is target["block"]["attn"]["wq"]["w"]:
            o = o * 0
        return o, kind_

    def flip(self, state, batch):
        floats = lambda params: [t for leaf in reference_leaves(params)  # noqa: E731
                                 for t in leaf.tensors if t.is_floating_point()]
        before = [t.detach().clone() for t in floats(state.params)]
        state, metrics = sound_call(self, state, batch)
        with torch.no_grad():
            for p0, p in zip(before, floats(state.params)):
                p.mul_(-1).add_(p0, alpha=2)  # p0 - (p - p0)
        return state, metrics

    def swap(api, params, batch, **kw):
        loss, metrics, grads = sound_gradients(api, params, batch, **kw)
        for leaf, g in zip(reference_leaves(params), grads):
            if leaf.path.endswith("moe/w_up/w"):
                row = g[len(g) // 2]
                row[[EXPERT, EXPERT + 1]] = row[[EXPERT + 1, EXPERT]]
        return loss, metrics, grads

    if kind == "control":
        patch(train_step, "open_program", reference)
    else:
        patch(train_step, "open_program", opened)
    if kind == "stale":
        patch(step.TrainStep, "__call__", stale)
    if kind == "half":
        patch(step.TrainStep, "__call__", half)
    if kind == "expert":
        patch(moe, "_experts", experts)
    if kind == "layer":
        patch(attention, "attend", attend)
    if kind == "flip":
        patch(step.TrainStep, "__call__", flip)
    if kind == "swap":
        patch(step, "gradients", swap)
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
