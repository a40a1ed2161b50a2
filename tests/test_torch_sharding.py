"""The port's sharding rules and meshes (`repro_torch.parallel.sharding`,
`repro_torch.launch.mesh`) against the reference's, in one process.

A spec is a pure function of (path, shape, axis sizes), so it is held
exact. The reference's rules run here without fake devices: its
`use_mesh` takes a stand-in mesh object (`axis_names`, `devices =
np.empty(shape)`), and its parameter shapes come from `jax.eval_shape` of
its `init` at full size (no weights drawn). `constraint` under a mesh
leaves a model's values unchanged: exact equality.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config as tget
from repro_torch.launch import make_host_mesh, make_production_mesh
from repro_torch.models import build as tbuild
from repro_torch.models import params_from_jax
from repro_torch.models.convert import Stack
from repro_torch.parallel import Mesh, P, data_mesh, mesh_axis_size, param_specs
from repro_torch.parallel import sharding as tsh

PRODUCTION = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names, self.devices = names, np.empty(shape)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def meta_mesh(shape, names) -> Mesh:
    return Mesh((torch.device("meta"),) * int(np.prod(shape)), names, shape)


@pytest.fixture(scope="module")
def full_shapes():
    """{arch: [(path, shape)]} of every parameter at full size, from the
    reference's `jax.eval_shape` of its init."""
    return {a: [(p, tuple(x.shape)) for p, x in jsh.tree_paths(
        jax.eval_shape(jbuild(jget(a)).init, jax.random.key(0)))] for a in ARCH_IDS}


@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh_name", list(PRODUCTION))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference_at_full_size(full_shapes, arch, mesh_name, serving):
    shape, names = PRODUCTION[mesh_name]
    fsdp = jget(arch).fsdp_pods
    assert tget(arch).fsdp_pods == fsdp
    with jsh.use_mesh(StandIn(shape, names)):
        want = [tuple(jsh.spec_for(p, s, fsdp, serving)) for p, s in full_shapes[arch]]
    mesh = make_production_mesh(multi_pod=len(shape) == 3)
    assert mesh.shape == dict(zip(names, shape))
    with tsh.use_mesh(mesh):
        got = [tsh.spec_for(p, s, fsdp, serving) for p, s in full_shapes[arch]]
    assert got == want
    assert all(isinstance(g, P) for g in got)
    # the rules shard something at both meshes, and the fsdp-over-pods
    # model takes ("data", "pod")
    assert any(any(e is not None for e in g) for g in got)
    if fsdp and not serving and len(shape) == 3:
        assert any(("data", "pod") in g for g in got)


def test_rules_match_the_reference_test_values():
    """The values `tests/test_sharding_rules.py::test_param_rules_on_mesh`
    asserts of the reference, at (4, 2)."""
    with tsh.use_mesh(meta_mesh((4, 2), ("data", "model"))):
        assert tsh.spec_for("blocks/s0/attn/wq/w", (3, 64, 128)) == (None, "data", "model")
        assert tsh.spec_for("blocks/s0/attn/wq/w", (3, 63, 128)) == (None, None, "model")
        assert tsh.spec_for("moe/w_up/w", (8, 64, 32)) == ("model", "data", None)
        assert tsh.spec_for("embed/tok/w", (1024, 64)) == ("model", "data")
        assert tsh.spec_for("blocks/s0/ln1/scale", (3, 64)) == (None, None)
        assert tsh.spec_for("mlp/w_up/w", (64, 128), serving=True) == (None, "model")
        assert tsh.seq_axis(16) == "model"
        assert tsh.seq_axis(1) is None
        assert tsh.seq_axis(17) is None
        assert tsh.batch_axes() == ("data",)
        assert tsh.axis("pod") is None and tsh.axis("model") == "model"
    # no mesh: every axis resolves to None, as in the reference
    assert tsh.current_mesh() is None and tsh.batch_axes() is None
    assert tsh.spec_for("blocks/s0/attn/wq/w", (3, 64, 128)) == (None, None, None)
    assert jsh.spec_for("blocks/s0/attn/wq/w", (3, 64, 128)) == P(None, None, None)


@pytest.mark.parametrize("arch", ["granite_moe_hash", "llama4_maverick_400b_a17b",
                                  "jamba_v0_1_52b", "whisper_large_v3",
                                  "gemma3_27b_hashed"])
def test_param_specs_of_a_port_tree_equal_reference(arch):
    """Over a smoke-size port tree (carried across from the reference's
    tree of its shapes; a spec reads shapes only): every leaf's spec is the
    reference's, a per-block tensor's without the stacked leaf's leading
    None."""
    jparams = jax.eval_shape(jbuild(jget(arch, smoke=True)).init, jax.random.key(0))
    tree = params_from_jax(tget(arch, smoke=True),
                           jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jparams),
                           device="cpu")
    for fsdp in (False, True):
        with jsh.use_mesh(StandIn((4, 2), ("data", "model"))):
            want = dict(jsh.tree_paths(jsh.param_specs(jparams, fsdp)))
        with tsh.use_mesh(meta_mesh((4, 2), ("data", "model"))):
            got = dict(tsh.tree_paths(param_specs(tree, fsdp)))
        assert set(got) == set(want)
        stacked = 0
        for path, spec in got.items():
            if isinstance(spec, Stack):
                stacked += 1
                assert all(s == tuple(want[path])[1:] for s in spec), path
                assert tuple(want[path])[0] is None
            else:
                assert spec == tuple(want[path]), path
        assert stacked


def test_make_host_mesh_matches_reference(monkeypatch):
    """The squarest (data, model) factorization with model <= data, for
    n = 1..64 logical shards, as the reference's over n devices."""
    import repro.launch.mesh as jmesh

    for n in range(1, 65):
        monkeypatch.setattr(jmesh.jax, "devices", lambda n=n: [None] * n)
        monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (shape, axes))
        want = jmesh.make_host_mesh()
        got = make_host_mesh(device="cpu", n_shards=n)
        assert (got.dims, got.axis_names) == want, n
        assert got.size == n and set(got.devices) == {torch.device("cpu")}


def test_production_meshes_are_meta_shapes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    assert m.devices[0].type == "meta"
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    m = make_production_mesh(device="cpu")
    assert m.devices == (torch.device("cpu"),) * 256


def test_mesh_shape_coords_and_axis_size():
    m = meta_mesh((2, 4, 3), ("pod", "data", "model"))
    assert mesh_axis_size(m, "pod") == 2
    assert mesh_axis_size(m, "data") == 4
    assert mesh_axis_size(m, "model") == 3
    assert mesh_axis_size(m, "other") == 1
    coords = [m.coords(r) for r in range(m.size)]
    assert coords[0] == {"pod": 0, "data": 0, "model": 0}
    assert coords[23] == {"pod": 1, "data": 3, "model": 2}
    assert coords == [dict(zip(m.axis_names, ix)) for ix in np.ndindex(2, 4, 3)]
    d = data_mesh(device="cpu", n_shards=4)
    assert d.shape == {"data": 4} and mesh_axis_size(d, "data") == 4
    with pytest.raises(ValueError):
        Mesh((torch.device("cpu"),) * 6, ("data", "model"), (2, 2))


def test_p_equals_the_reference_partition_spec():
    from jax.sharding import PartitionSpec

    for entries in [(), (None,), ("data", "model"), (None, ("data", "pod"), "model")]:
        assert P(*entries) == tuple(PartitionSpec(*entries))
    import copy
    import pickle

    p = P(None, ("data", "pod"))
    assert copy.deepcopy(p) == p and pickle.loads(pickle.dumps(p)) == p
    assert isinstance(copy.copy(p), P)


def _batch(cfg, seed=0, B=2, T=16):
    g = np.random.default_rng(seed)
    b = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)),
         "labels": torch.from_numpy(g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32))}
    if cfg.encdec:
        b["frames"] = torch.from_numpy(
            g.normal(size=(B, cfg.encoder_positions, cfg.d_model)).astype(np.float32))
    if cfg.vision_prefix:
        b["patch_embeds"] = torch.from_numpy(
            g.normal(size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32))
    return b


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_constraint_leaves_model_values_unchanged(arch):
    """A smoke loss and its gradients, and a decode step, under
    `use_mesh` (the constraint calls resolve; no process group, so the
    batch means stay local) equal the same without a mesh, exactly."""
    cfg = dataclasses.replace(tget(arch, smoke=True), dtype="float32")
    api = tbuild(cfg)
    params = api.init(torch.Generator().manual_seed(0), train=True)
    batch = _batch(cfg)
    trained = [p for p in params.parameters() if p.requires_grad]

    def run():
        loss, _ = api.loss(params, batch, moe_groups=2 if cfg.n_experts else 1)
        grads = torch.autograd.grad(loss, trained)
        if cfg.encdec:
            logits, _ = api.prefill(params, {"frames": batch["frames"],
                                             "tokens": batch["tokens"]})
        else:
            logits, caches = api.prefill(params, {"tokens": batch["tokens"]},
                                         cache_len=20)
            logits, _ = api.decode_step(params, caches, batch["tokens"][:, :1], 16)
        return [loss, logits, *grads]

    plain = run()
    with tsh.use_mesh(meta_mesh((2, 2, 2), ("pod", "data", "model"))):
        under = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, under))
