"""The port's placements (`NamedSharding`, `state_shardings`) and
`hierarchical_psum` against the reference's, and against a world of
threaded ranks on the CPU (`repro_torch.parallel.local_world`).

The reference's chunk maps (`NamedSharding.devices_indices_map`), its
`state_shardings` specs and its `hierarchical_psum` values come from one
subprocess with 8 fake host devices (module fixture), as
`tests/test_sharding_rules.py` runs them. Chunks, specs and the
integer-valued sums are held exact.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.models import build as tbuild
from repro_torch.parallel import Mesh, NamedSharding, P, batch_sharding, local_world
from repro_torch.parallel import collectives as tcol
from repro_torch.parallel import sharding as tsh
from repro_torch.train import Schedule, init_state, make_optimizer, state_shardings

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
AXES = ("pod", "data", "model")
SHAPE = (8, 8, 4)
SPECS = [(), ("data",), ("pod",), (("pod", "data"),), (("data", "pod"),),
         (None, "model"), (("data", "pod"), "model"), ("model", ("data", "pod")),
         (None, ("data", "pod"), "model"), ("pod", None, "data"),
         (("model", "pod"), "data"), (("data", "pod", "model"),)]
STATE_ARCHS = {"granite_moe_hash": False, "llama4_maverick_400b_a17b": True,
               "mistral_nemo_12b": False}


def cpu_mesh(shape=(2, 2, 2), names=AXES) -> Mesh:
    return Mesh((torch.device("cpu"),) * int(np.prod(shape)), names, shape)


@pytest.fixture(scope="module")
def reference():
    """The reference's chunk maps on a (2, 2, 2) mesh, its
    hierarchical_psum values and its smoke-size state_shardings specs."""
    code = f"""
        import json
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from repro.configs import get_config
        from repro.models import build
        from repro.parallel.collectives import hierarchical_psum
        from repro.train import Schedule, init_state, make_optimizer
        from repro.train.train_state import state_shardings
        from repro.parallel.sharding import tree_paths, use_mesh

        devs = np.array(jax.devices()[:8])
        mesh = Mesh(devs.reshape(2, 2, 2), {AXES!r})
        flat = list(mesh.devices.flat)
        out = {{"chunks": [], "psum": {{}}, "state": {{}}}}
        for spec in {SPECS!r}:
            m = NamedSharding(mesh, P(*spec)).devices_indices_map({SHAPE!r})
            out["chunks"].append([[[s.start or 0, s.stop if s.stop is not None else n]
                                   for s, n in zip(m[d], {SHAPE!r})] for d in flat])
        x = jnp.arange(16.0)
        out["psum"]["pod"] = np.asarray(hierarchical_psum(x, mesh)).tolist()
        mesh2 = Mesh(devs.reshape(4, 2), ("data", "model"))
        out["psum"]["flat"] = np.asarray(hierarchical_psum(jnp.arange(8.0), mesh2)).tolist()
        for arch, fsdp in {STATE_ARCHS!r}.items():
            cfg = get_config(arch, smoke=True)
            api = build(cfg)
            opt = make_optimizer(cfg.optimizer, Schedule())
            st = jax.eval_shape(lambda k: init_state(api, opt, k), jax.random.key(0))
            # its specs resolve against the current mesh, not the argument
            with use_mesh(mesh):
                sh = state_shardings(st, mesh, fsdp)
            out["state"][arch] = {{
                p: [list(e) if isinstance(e, tuple) else e for e in s.spec]
                for p, s in tree_paths(sh) if hasattr(s, "spec")}}
        print("JSON" + json.dumps(out))
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=420)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [s for s in run.stdout.splitlines() if s.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.mark.parametrize("i", range(len(SPECS)), ids=[str(s) for s in SPECS])
def test_chunks_equal_jax_devices_indices_map(reference, i):
    mesh = cpu_mesh()
    s = NamedSharding(mesh, P(*SPECS[i]))
    got = [[[sl.start, sl.stop] for sl in s.chunk(SHAPE, r)] for r in range(mesh.size)]
    assert got == reference["chunks"][i]
    assert s.local_shape(SHAPE) == tuple(b - a for a, b in got[0])


def test_dtensor_placements_hold_each_rank_its_chunk():
    """`distribute_tensor` with `NamedSharding.placements` gives every rank
    of a threaded (2, 2, 2) world its `chunk`, ("data", "pod") included
    (`_StridedShard`)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = cpu_mesh()
    full = torch.arange(float(np.prod(SHAPE))).reshape(SHAPE)

    def rank(r):
        dm = tsh.device_mesh(mesh)
        out = []
        for spec in SPECS:
            s = NamedSharding(mesh, P(*spec))
            d = distribute_tensor(full, dm, s.placements(full.ndim))
            out.append(torch.equal(d.to_local(), s.local(full, r))
                       and torch.equal(d.full_tensor(), full))
        return out

    assert all(all(r) for r in local_world.run(rank, mesh))


def test_constraint_redistributes_a_dtensor():
    """Under the mesh, `constraint` moves a DTensor to the resolved spec
    (values unchanged); a plain tensor and a tensor with no mesh pass as
    they are."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = cpu_mesh()
    full = torch.arange(64.0).reshape(8, 8)

    def rank(r):
        dm = tsh.device_mesh(mesh)
        d = distribute_tensor(full, dm, [Replicate()] * 3)
        e = tsh.constraint(d, "batch", "model")
        want = NamedSharding(mesh, P(("pod", "data"), "model"))
        return (torch.equal(e.to_local(), want.local(full, r))
                and torch.equal(e.full_tensor(), full)
                and tsh.constraint(full, "batch", None) is full)

    assert all(local_world.run(rank, mesh))
    assert tsh.constraint(full, "batch", "model") is full


def test_batch_sharding_splits_rows_over_pod_and_data():
    mesh = cpu_mesh()
    s = batch_sharding(mesh, 2)
    assert s.spec == (("pod", "data"), None)
    rows = [s.chunk((8, 3), r)[0] for r in range(8)]
    assert [(x.start, x.stop) for x in rows] == [(0, 2), (0, 2), (2, 4), (2, 4),
                                                 (4, 6), (4, 6), (6, 8), (6, 8)]
    # the reference's too: the names as a tuple, P(("data",), None, None)
    assert batch_sharding(cpu_mesh((4, 2), ("data", "model")), 3).spec == (("data",), None, None)


def test_hierarchical_psum_is_exact(reference):
    """Each rank passes its shard of the reference's global input: the
    result is the plain sum over (pod, data) of the shards, and the
    reference's values, exactly; the cross-pod hop moves 1/2 of the
    bytes of the in-pod reduce-scatter."""
    x = torch.arange(16.0)
    for name, mesh, inner in (("pod", cpu_mesh(), P(("pod", "data"))),
                              ("flat", cpu_mesh((4, 2), ("data", "model")), P("data"))):
        xs = x[:8] if name == "flat" else x
        s = NamedSharding(mesh, inner)

        def rank(r, xs=xs, s=s, mesh=mesh):
            traffic = {}
            y = tcol.hierarchical_psum(s.local(xs, r), mesh, traffic=traffic)
            return y, traffic

        out = local_world.run(rank, mesh)
        n_shards = 4
        plain = sum(xs.view(n_shards, -1)[i] for i in range(n_shards))
        for y, traffic in out:
            assert torch.equal(y, plain)
            assert y.tolist() == reference["psum"][name]
        traffic = out[0][1]
        if name == "pod":
            assert traffic == {"reduce_scatter/data": 8, "all_reduce/pod": 8,
                               "all_gather/data": 8}
        else:
            assert traffic == {"all_reduce/data": 12}


@pytest.mark.parametrize("arch", list(STATE_ARCHS))
def test_state_shardings_equal_reference(reference, arch):
    """Every leaf of the train state (step, parameters, optimizer state)
    takes the reference's spec, adafactor's truncated statistics and the
    key planes' included."""
    cfg = tget(arch, smoke=True)
    api = tbuild(cfg)
    opt = make_optimizer(cfg.optimizer, Schedule())
    state = init_state(api, opt, torch.Generator().manual_seed(0))
    from repro_torch.train.train_state import skeleton

    got = {}
    for p, s in flatten_with_paths(state_shardings(skeleton(state), cpu_mesh(),
                                                   STATE_ARCHS[arch])):
        spec = (None, *s[0].spec) if isinstance(s, list) else s.spec
        got[p] = [list(e) if isinstance(e, tuple) else e for e in spec]
    want = reference["state"][arch]
    assert set(got) == set(want)
    for p in want:
        n = len(want[p])
        assert got[p] + [None] * (n - len(got[p])) == want[p], p
