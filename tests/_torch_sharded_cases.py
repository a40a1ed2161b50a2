"""Shared cases of `tests/test_torch_sharded_step*.py`: the sharded train
step (`repro_torch.train.jit_train_step`) on worlds of threaded CPU ranks
(`repro_torch.parallel.local_world`) against the reference's unsharded
step. One file a case or two, so that each stays under 30 s on one core
and `--dist loadfile` spreads them. The other families' sharded steps
are held against the reference in their `tests/test_torch_train_*.py`
files, on the reference run those files compile anyway.

Smoke configs in f32, 2 steps (lr 1e-3, no warmup) from the reference's
`init_state`, carried across by `train_state.from_reference`. The
reference's `make_train_step` runs with `moe_groups` equal to the batch
ranks (a rank's tokens are one MoE group, as the reference's dry run sets
it) and the case's `grad_accum` on the same seeded batches. Its init and step are jitted at XLA's
backend optimization level 0 (`REFERENCE_XLA`): the same program,
compiled in a third of the time. Each rank's chunks of the state after
each step are held against the same chunks of the reference's state, with
the tolerances of the train tests: parameters within 2 x (the sum of the
learning rates) + 1e-5 everywhere and at most FLIPS elements past 1e-5
(an element whose gradient is within rounding of 0 may take AdamW's step
the other way), the optimizer's state within 1e-3 of its leaf's largest
magnitude + 1e-9, the metrics within rel 1e-4 (atol 1e-6); integer leaves
(key planes) exactly. The sums of a sharded step run in another order, so
they are not bit for bit.
"""
import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.train import Schedule as JSchedule
from repro.train import init_state as jinit_state
from repro.train import make_optimizer as jmake_optimizer
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.models import build
from repro_torch.parallel import Mesh, batch_sharding, local_world
from repro_torch.train import Schedule, jit_train_step, make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import copy_to, from_reference, shard, to_reference

REFERENCE_XLA = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}
LR = dict(peak_lr=1e-3, warmup_steps=0)
FLIPS = 64
B, T, N_STEPS = 8, 16, 2
POD = ("pod", "data", "model")


class Case(NamedTuple):
    arch: str
    dims: tuple
    axes: tuple = ("data", "model")
    fsdp_pods: bool = False
    masked: bool = False        # a mask whose token counts differ by rank
    grad_accum: int = 1


CASES = {
    "granite_adamw_2x2": Case("granite_moe_1b_a400m", (2, 2)),
    "granite_masked_accum2_2x2": Case("granite_moe_1b_a400m", (2, 2), masked=True,
                                      grad_accum=2),
    "granite_hash_2x2x2": Case("granite_moe_hash", (2, 2, 2), POD),
    "llama4_adafactor_fsdp_pods_2x2x2": Case("llama4_maverick_400b_a17b", (2, 2, 2), POD,
                                             fsdp_pods=True),
    "mistral_masked_2x2x2": Case("mistral_nemo_12b", (2, 2, 2), POD, masked=True),
    # four ranks share one KV head's columns
    "phi3_1x8": Case("phi3_medium_14b", (1, 8)),
}


def batches(cfg, masked: bool):
    g = np.random.default_rng(7)
    out = []
    for _ in range(N_STEPS):
        b = {"tokens": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "labels": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
        if masked:
            b["mask"] = (np.arange(T)[None, :] < g.integers(1, T + 1, (B, 1))).astype(
                np.float32)
        out.append(b)
    return out


def batch_ranks(dims, axes) -> int:
    return int(np.prod([n for n, a in zip(dims, axes) if a in ("pod", "data")]))


@functools.lru_cache(maxsize=None)
def reference_run(case):
    """The reference's jitted unsharded step (`moe_groups` = the batch
    ranks) from its init_state (key 0), both jitted with `REFERENCE_XLA`,
    -> (the first state, the batches, each step's state and metrics), as
    numpy."""
    c = CASES[case]
    jc = dataclasses.replace(jget(c.arch, smoke=True), dtype="float32")
    japi = jbuild(jc)
    jopt = jmake_optimizer(jc.optimizer, JSchedule(**LR))
    jstate = jax.jit(lambda k: jinit_state(japi, jopt, k),
                     compiler_options=REFERENCE_XLA)(jax.random.key(0))
    run = jax.jit(jmake_train_step(japi, jopt, moe_groups=batch_ranks(c.dims, c.axes),
                                   grad_accum=c.grad_accum),
                  compiler_options=REFERENCE_XLA)
    first, data = jax.tree.map(np.asarray, jstate), batches(jc, c.masked)
    states, metrics = [], []
    for b in data:
        jstate, m = run(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(jax.tree.map(np.asarray, jstate))
        metrics.append({k: float(v) for k, v in m.items()})
    return first, data, states, metrics


def assert_close(got, want, lr_sum: float) -> None:
    a = dict(flatten_with_paths(to_reference(got)))
    w = dict(flatten_with_paths(to_reference(want)))
    assert set(a) == set(w)
    flips = 0
    for path, x in w.items():
        y = a[path]
        assert y.shape == x.shape and y.dtype == x.dtype, path
        if not x.is_floating_point():
            assert torch.equal(y, x), path
            continue
        err = (y - x).abs()
        if path.startswith(".params"):
            assert float(err.max()) <= 2 * lr_sum + 1e-5, path
            flips += int((err > 1e-5).sum())
        else:
            assert float(err.max()) <= 1e-3 * float(x.abs().max()) + 1e-9, path
    assert flips <= FLIPS, flips


def check_matches_reference(case):
    """Every rank's chunks and the metrics after each step == the
    reference's unsharded step's (`reference_run`)."""
    c = CASES[case]
    cfg = dataclasses.replace(get_config(c.arch, smoke=True), dtype="float32")
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, Schedule(**LR))
    first, data, ref_states, metrics = reference_run(case)
    state = from_reference(cfg, first, device="cpu")
    states = [from_reference(cfg, s, device="cpu") for s in ref_states]
    mesh = Mesh((torch.device("cpu"),) * int(np.prod(c.dims)), c.axes, c.dims)
    n_batch = batch_ranks(c.dims, c.axes)
    step = make_train_step(api, opt, moe_groups=n_batch, grad_accum=c.grad_accum)
    sharded = jit_train_step(step, mesh, state, {k: v.ndim for k, v in data[0].items()},
                             fsdp_pods=c.fsdp_pods)

    def rank(r):
        local, out = shard(state, mesh, r, c.fsdp_pods), []
        for b in data:
            lb = {k: batch_sharding(mesh, v.ndim).local(torch.from_numpy(v), r)
                  for k, v in b.items()}
            local, m = sharded(local, lb)
            out.append((copy_to(local, "cpu"), m))
        return [(s, m, shard(w, mesh, r, c.fsdp_pods)) for (s, m), w in zip(out, states)]

    lr_sum = 0.0
    for i, per_rank in enumerate(zip(*local_world.run(rank, mesh))):
        assert all(int(got.step) == int(want.step) == i + 1 for got, _, want in per_rank)
        want_m = metrics[i]
        lr_sum += want_m["lr"]
        for got, m, want in per_rank:
            assert_close(got, want, lr_sum)
            for k in ("loss", "ce", "balance", "grad_norm", "lr"):
                np.testing.assert_allclose(float(m[k]), want_m[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
            if n_batch > 1:
                assert m["traffic"]["reduce_scatter/data"] > 0
            else:
                assert m["traffic"]["reduce_scatter/model"] > 0
