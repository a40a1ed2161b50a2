"""The sharded train step on a (2, 2) world of threaded CPU ranks for the
learned MoE router under AdamW against the reference's unsharded step
(cases and tolerances: `tests/_torch_sharded_cases.py`); the dtype each
leaf is gathered in; donation; what `jit_train_step` refuses."""
import dataclasses

import pytest
import torch

from _torch_sharded_cases import LR, batches, check_matches_reference
from repro_torch.configs import get_config, list_configs
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.models import build
from repro_torch.models.convert import held_dtype, reference_leaves
from repro_torch.parallel import Mesh, batch_sharding, local_world
from repro_torch.train import Schedule, init_state, jit_train_step, make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import copy_to, shard, to_reference


@pytest.mark.parametrize("case", ["granite_adamw_2x2"])
def test_sharded_step_matches_single_device(case):
    check_matches_reference(case)


def test_gathers_read_leaves_in_the_dtype_the_models_hold_them():
    """The sharded step gathers a float leaf in `convert.held_dtype`'s
    dtype: for every family that is the dtype its serving tree holds the
    leaf in (f32 where the model reads it uncast, else the compute dtype,
    cast at use), so a leaf a model reads uncast is never rounded."""
    for name in list_configs():
        cfg = get_config(name, smoke=True)
        params = build(cfg).init(torch.Generator().manual_seed(0))
        compute = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        for leaf in reference_leaves(params):
            t = leaf.tensors[0]
            if t.is_floating_point():
                assert held_dtype(tuple(leaf.path.split("/")), compute) == t.dtype, \
                    (name, leaf.path)


def test_sharded_step_without_donation_keeps_its_input():
    cfg = dataclasses.replace(get_config("granite_moe_hash", smoke=True), dtype="float32")
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, Schedule(**LR))
    state = init_state(api, opt, torch.Generator().manual_seed(0))
    mesh = Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))
    step = make_train_step(api, opt, moe_groups=2)
    b = batches(cfg, False)[0]
    kept = jit_train_step(step, mesh, state, {"tokens": 2, "labels": 2}, donate=False)
    donated = jit_train_step(step, mesh, state, {"tokens": 2, "labels": 2})

    def rank(r):
        local = shard(state, mesh, r)
        before = dict(flatten_with_paths(to_reference(copy_to(local, "cpu"))))
        lb = {k: batch_sharding(mesh, 2).local(torch.from_numpy(v), r) for k, v in b.items()}
        new, _ = kept(local, lb)
        same = all(torch.equal(x, before[p])
                   for p, x in flatten_with_paths(to_reference(local)))
        new2, _ = donated(local, lb)
        moved = not all(torch.equal(x, before[p]) for p, x in
                        flatten_with_paths(to_reference(local)) if x.is_floating_point())
        return same, moved, new is not local, new2.params is local.params

    assert all(all(r) for r in local_world.run(rank, mesh))


def test_jit_train_step_refuses_groups_that_span_ranks():
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, Schedule(**LR))
    state = init_state(api, opt, torch.Generator().manual_seed(0))
    mesh = Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="multiple"):
        jit_train_step(make_train_step(api, opt), mesh, state, {"tokens": 2})
    with pytest.raises(TypeError):
        jit_train_step(lambda s, b: (s, {}), mesh, state, {"tokens": 2})


def test_jit_train_step_refuses_microbatches_the_batch_ranks_do_not_split():
    """4 rows in 4 microbatches of 1 row: 2 batch ranks cannot split one."""
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m", smoke=True),
                              dtype="float32")
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, Schedule(**LR))
    state = init_state(api, opt, torch.Generator().manual_seed(0))
    mesh = Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))
    b = {k: v[:4] for k, v in batches(cfg, False)[0].items()}
    sharded = jit_train_step(make_train_step(api, opt, moe_groups=2, grad_accum=4), mesh,
                             state, {"tokens": 2, "labels": 2})

    def rank(r):
        lb = {k: batch_sharding(mesh, 2).local(torch.from_numpy(v), r) for k, v in b.items()}
        return sharded(shard(state, mesh, r), lb)

    with pytest.raises(ValueError, match="do not split over the 2 batch ranks"):
        local_world.run(rank, mesh)
