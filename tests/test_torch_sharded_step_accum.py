"""The sharded train step on a (2, 2) world of threaded CPU ranks: two
microbatches of the global batch with a mask whose token counts differ by
rank, against the reference's unsharded step (cases and tolerances:
`tests/_torch_sharded_cases.py`); bf16 against the port's single-device
step."""
import numpy as np
import pytest
import torch

from _torch_sharded_cases import LR, batches, check_matches_reference
from repro_torch.configs import get_config
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.models import build
from repro_torch.parallel import Mesh, batch_sharding, local_world
from repro_torch.train import Schedule, init_state, jit_train_step, make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import copy_to, shard, to_reference


@pytest.mark.parametrize("case", ["granite_masked_accum2_2x2"])
def test_sharded_step_matches_single_device(case):
    check_matches_reference(case)


# `tests/test_torch_models.py`'s bf16 bound on an f32 state summed from bf16
# inputs (of its leaf's largest magnitude)
BF16_STATE = 2.0 ** -5


def test_sharded_step_in_bf16_matches_the_single_device_step():
    """granite_moe_hash SMOKE in bf16 (the hash router: no route flips on
    near ties) on a (2, 2) world, one step, against the port's
    single-device bf16 step: each rank gathers its weights in bf16 (the
    single-device step casts the same f32 masters at use) and sums its
    gradients' bf16 partial products in another order, and the partial
    sums of its experts' and heads' outputs are added in bf16 across the
    ranks. So the optimizer's state, f32 sums of bf16 products, is held as
    the model tests hold such states: the first moment (0.1 g) within
    BF16_STATE of its leaf's largest magnitude, the second (0.001 g^2,
    whose relative error is twice g's) within 2 BF16_STATE + BF16_STATE^2;
    the loss within rel 2e-3 (the train tests' bf16 bound); the parameters
    within 2 lr + 1e-5."""
    cfg = get_config("granite_moe_hash", smoke=True)
    assert cfg.dtype == "bfloat16"
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, Schedule(**LR))
    state = init_state(api, opt, torch.Generator().manual_seed(0))
    mesh = Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))
    step = make_train_step(api, opt, moe_groups=2)
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, False)[0].items()}
    want, want_m = step(copy_to(state, "cpu"), b)
    sharded = jit_train_step(step, mesh, state, {"tokens": 2, "labels": 2})

    def rank(r):
        lb = {k: batch_sharding(mesh, 2).local(v, r) for k, v in b.items()}
        got, m = sharded(shard(state, mesh, r), lb)
        return got, m, shard(want, mesh, r)

    for got, m, w in local_world.run(rank, mesh):
        a = dict(flatten_with_paths(to_reference(got)))
        for path, x in flatten_with_paths(to_reference(w)):
            if not x.is_floating_point():
                assert torch.equal(a[path], x), path
                continue
            err = float((a[path] - x).abs().max())
            rel = 2 * BF16_STATE + BF16_STATE ** 2 if path.startswith(".opt_state/v") \
                else BF16_STATE
            bound = (2 * LR["peak_lr"] + 1e-5 if path.startswith(".params")
                     else rel * float(x.abs().max()) + 1e-9)
            assert err <= bound, (path, err, bound)
        np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"]), rtol=2e-3)
