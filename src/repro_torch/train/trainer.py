"""Training loop with fault tolerance: periodic verified checkpoints,
auto-resume from the latest VALID checkpoint, a straggler/hang watchdog,
and preemption simulation hooks (exercised by tests + examples).

The port of `repro.train.trainer`. The trainer runs on `device` (the card
unless the caller passes another); its parameters are drawn from `gen`, a
`torch.Generator` on that device (default: seed 0), whose state is kept
so every fresh start draws the same weights. Checkpoints hold the state
in the reference's layout (`train_state.to_reference`): the reference's
leaf paths, shapes and dtypes, each leaf fingerprinted on the device by
the tree hasher (one `multihash` launch a leaf).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..core.device import resolve_device
from .optimizer import Schedule, make_optimizer
from .step import make_train_step
from .train_state import TrainState, from_reference, init_state, skeleton, to_reference


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    # under the temporary directory (TMPDIR); the reference's is a fixed path
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10
    # straggler/hang watchdog: if a step exceeds deadline_factor x the median
    # step time (after warmup), flag it; after `max_stragglers` consecutive
    # flags, trigger checkpoint + (simulated) restart.
    deadline_factor: float = 5.0
    max_stragglers: int = 3
    peak_lr: float = 3e-3
    warmup_steps: int = 20
    moe_groups: int = 1
    grad_accum: int = 1


class Trainer:
    def __init__(self, api, tcfg: TrainerConfig, gen: torch.Generator | None = None,
                 device=None):
        self.api = api
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(
            api.cfg.optimizer,
            Schedule(peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
                     decay_steps=tcfg.total_steps))
        self.ckpt = Checkpointer(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints,
                                 device=self.device)
        self.step_fn = make_train_step(api, self.optimizer,
                                       moe_groups=tcfg.moe_groups,
                                       grad_accum=tcfg.grad_accum)
        self._gen = gen if gen is not None else torch.Generator(
            self.device).manual_seed(0)
        self._gen_state = self._gen.get_state()
        self.metrics_log: list[dict] = []
        self._step_times: list[float] = []
        self._straggler_strikes = 0
        self.restarts = 0

    # -- state / resume -----------------------------------------------------

    def init_or_resume(self) -> TrainState:
        self._gen.set_state(self._gen_state)
        state = init_state(self.api, self.optimizer, self._gen)
        latest = self.ckpt.latest_valid()
        if latest is not None:
            ref = self.ckpt.restore(latest, skeleton(state))
            del state
            state = from_reference(self.api.cfg, ref, self.device)
            self.restarts += 1
        return state

    def save(self, step: int, state: TrainState) -> str:
        return self.ckpt.save(step, to_reference(state))

    # -- watchdog -----------------------------------------------------------

    def _watchdog(self, dt: float) -> bool:
        """Returns True if this step counts as a straggler event."""
        self._step_times.append(dt)
        if len(self._step_times) < 8:
            return False
        median = float(np.median(self._step_times[-32:]))
        if dt > self.tcfg.deadline_factor * median:
            self._straggler_strikes += 1
            return True
        self._straggler_strikes = 0
        return False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loop ---------------------------------------------------------------

    def train(self, batches: Iterator[dict], fault_injector: Callable | None = None):
        """Run to total_steps. `fault_injector(step)` may raise
        SimulatedFault to exercise the checkpoint-restart path."""
        state = self.init_or_resume()
        step = int(state.step)  # host-side mirror, re-synced on restore
        while step < self.tcfg.total_steps:
            batch = next(batches)
            t0 = time.monotonic()
            try:
                if fault_injector is not None:
                    fault_injector(step)
                state, metrics = self.step_fn(state, batch)
                self._sync()
            except SimulatedFault:
                # crash-consistent restart: resume from the latest VALID
                # checkpoint and REPLAY from its step (work since the last
                # checkpoint is redone -- exactly-once is not a training
                # property; determinism comes from content-hashed data)
                del state
                state = self.init_or_resume()
                step = int(state.step)
                continue
            step += 1
            dt = time.monotonic() - t0
            straggled = self._watchdog(dt)
            if straggled and self._straggler_strikes >= self.tcfg.max_stragglers:
                self.save(step, state)
                self._straggler_strikes = 0
                self.restarts += 1  # (real cluster: re-form mesh w/o host)
            if (step - 1) % self.tcfg.log_every == 0 or step == self.tcfg.total_steps:
                self.metrics_log.append(
                    {"step": step - 1, **{k: float(v) for k, v in metrics.items()}})
            if step % self.tcfg.checkpoint_every == 0:
                self.save(step, state)
        self.save(int(state.step), state)
        return state


class SimulatedFault(RuntimeError):
    """Raised by fault injectors to simulate preemption / node loss."""
