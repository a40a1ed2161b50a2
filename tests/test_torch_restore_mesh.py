"""`Checkpointer.restore(mesh=, fsdp_pods=)` (the sharded restore) on a
world of 8 threaded CPU ranks shaped (pod 2, data 2, model 2).

Every rank restores its own chunks under `train_state.state_shardings`;
each must equal its slice of the single-device restore of the same
checkpoint, exactly. Both packages' checkpoints restore this way: the
reference's `Checkpointer` saves its own `init_state`, the port's its
own. A flipped byte fails every rank (no rank waits on the others).
"""
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.train import Schedule as JSchedule
from repro.train import init_state as jinit_state
from repro.train import make_optimizer as jmake_optimizer
from repro_torch.checkpoint import Checkpointer, CorruptCheckpointError
from repro_torch.configs import get_config as tget
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.models import build as tbuild
from repro_torch.models.convert import Stack
from repro_torch.parallel import Mesh, NamedSharding, P, local_world
from repro_torch.train import Schedule, init_state, make_optimizer, state_shardings
from repro_torch.train.train_state import from_reference, shard, skeleton, to_reference

MESH = Mesh((torch.device("cpu"),) * 8, ("pod", "data", "model"), (2, 2, 2))


def port_state(name):
    cfg = tget(name, smoke=True)
    opt = make_optimizer(cfg.optimizer, Schedule())
    return cfg, init_state(tbuild(cfg), opt, torch.Generator().manual_seed(0))


def placed(like, fsdp):
    out = {}
    for p, s in flatten_with_paths(state_shardings(like, MESH, fsdp)):
        out[p] = NamedSharding(MESH, P(None, *s[0].spec)) if isinstance(s, Stack) else s
    return out


def assert_rank_slices(ck, step, like, fsdp):
    """Every rank's restore(mesh=) == its slices of the whole restore."""
    whole = dict(flatten_with_paths(ck.restore(step, like)))
    where = placed(like, fsdp)

    def rank(r):
        got = dict(flatten_with_paths(ck.restore(step, like, mesh=MESH, fsdp_pods=fsdp)))
        assert set(got) == set(whole)
        return all(torch.equal(got[p], where[p].local(x, r)) for p, x in whole.items())

    assert all(local_world.run(rank, MESH))
    return whole


@pytest.mark.parametrize("name,fsdp", [("llama4_maverick_400b_a17b", True),
                                       ("granite_moe_hash", False)])
def test_port_checkpoint_restores_onto_the_mesh(tmp_path, name, fsdp):
    cfg, state = port_state(name)
    ck = Checkpointer(str(tmp_path), device="cpu")
    ck.save(5, to_reference(state))
    whole = assert_rank_slices(ck, 5, skeleton(state), fsdp)
    # the restored chunks are the chunks the sharded step takes
    local = {p: x for p, x in flatten_with_paths(to_reference(shard(state, MESH, 3, fsdp)))}
    where = placed(skeleton(state), fsdp)
    assert all(torch.equal(where[p].local(x, 3), local[p]) for p, x in whole.items())


def test_reference_checkpoint_restores_onto_the_mesh(tmp_path):
    """The reference saves its own smoke state (AdamW, the hash router's
    u32 key planes); the port restores it onto the mesh."""
    jc = jget("granite_moe_hash", smoke=True)
    jstate = jinit_state(jbuild(jc), jmake_optimizer(jc.optimizer, JSchedule()),
                         jax.random.key(0))
    JCheckpointer(str(tmp_path)).save(2, jstate)
    cfg = tget("granite_moe_hash", smoke=True)
    like = skeleton(from_reference(cfg, jax.tree.map(np.asarray, jstate), device="cpu"))
    whole = assert_rank_slices(Checkpointer(str(tmp_path), device="cpu"), 2, like, False)
    assert any(x.dtype == torch.uint32 for x in whole.values())


def test_a_corrupt_leaf_fails_every_rank(tmp_path):
    _, state = port_state("granite_moe_hash")
    ck = Checkpointer(str(tmp_path), device="cpu")
    ck.save(1, to_reference(state))
    npz = os.path.join(tmp_path, "step_1", "arrays.npz")
    with zipfile.ZipFile(npz) as z:
        members = {n: z.read(n) for n in z.namelist()}
    name = sorted(members)[-1]
    raw = bytearray(members[name])
    raw[-1] ^= 0xFF
    members[name] = bytes(raw)
    with zipfile.ZipFile(npz, "w") as z:
        for n, b in members.items():
            z.writestr(n, b)
    like = skeleton(state)

    def rank(r):
        try:
            ck.restore(1, like, mesh=MESH)
        except CorruptCheckpointError:
            return True
        return False

    assert all(local_world.run(rank, MESH))


def test_a_state_that_is_not_a_train_state_restores_whole(tmp_path):
    ck = Checkpointer(str(tmp_path), device="cpu")
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.arange(5)}}
    ck.save(0, tree)
    out = local_world.run(lambda r: ck.restore(0, tree, mesh=MESH), MESH)
    for o in out:
        assert torch.equal(o["a"], tree["a"]) and torch.equal(o["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError):
        ck.restore(0, tree, fsdp_pods=True)
