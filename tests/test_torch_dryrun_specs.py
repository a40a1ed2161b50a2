"""The dry run's cache placements and the arguments of its serving cells
at full size, from shapes only, against the reference's
(`repro.launch.dryrun`; `tests/_torch_dryrun_cases.py`)."""
import jax
import pytest

from _torch_dryrun_cases import (PRODUCTION, StandIn, cells, reference_argument_bytes,
                                 reference_caches, reference_dryrun, specs_only)
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.launch import dryrun, make_production_mesh
from repro_torch.parallel import P

DECODE = [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
          if s not in get_config(a).skip_shapes]


def _jax_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): x
            for kp, x in flat}


@pytest.mark.parametrize("mesh_kind", list(PRODUCTION))
@pytest.mark.parametrize("arch,shape_name", DECODE)
def test_cache_specs_equal_reference(monkeypatch, arch, shape_name, mesh_kind):
    rd = reference_dryrun()
    dims, names = PRODUCTION[mesh_kind]
    shape = SHAPES[shape_name]
    long_ctx = shape.global_batch == 1
    caches_s = reference_caches(arch, shape_name)
    with specs_only(monkeypatch, rd):
        want = _jax_paths(rd.cache_shardings(caches_s, StandIn(dims, names), long_ctx))
    want_one = {p: rd.cache_pspec(p, x, long_ctx, StandIn(dims, names))
                for p, x in _jax_paths(caches_s).items()}
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    caches = dryrun.cache_shapes(get_config(arch), shape.global_batch, shape.seq_len)
    got = dict(flatten_with_paths(dryrun.cache_shardings(caches, mesh, long_ctx)))
    assert set(got) == set(want)
    for path, s in got.items():
        assert isinstance(s.spec, P)
        assert tuple(s.spec) == tuple(want[path]) == tuple(want_one[path]), path
        assert dryrun.cache_pspec(path, _shape(caches, path), long_ctx, mesh) == s.spec
    # the shapes too: the port's cache tree is the reference's
    shapes = dict(flatten_with_paths(caches))
    assert {p: tuple(x.shape) for p, x in shapes.items()} == \
        {p: tuple(x.shape) for p, x in _jax_paths(caches_s).items()}


def _shape(caches, path):
    return tuple(dict(flatten_with_paths(caches))[path].shape)


@pytest.mark.parametrize("arch,shape_name,mesh_kind", cells(("prefill", "decode")))
def test_serving_argument_bytes_equal_reference_shards(monkeypatch, arch, shape_name,
                                                       mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    got = dryrun.argument_bytes(get_config(arch), SHAPES[shape_name], mesh)
    assert got == reference_argument_bytes(monkeypatch, arch, shape_name, mesh_kind)


def test_cache_pspec_guards_divisibility():
    mesh = make_production_mesh()
    # 8 KV heads: S over model; a 1,500-frame cross cache does not split
    # over 16, so its S is replicated
    assert dryrun.cache_pspec("blocks/s0/k", (2, 128, 32768, 8, 128), False, mesh) == \
        P(None, "data", "model", None, None)
    assert dryrun.cache_pspec("blocks/s0/cross_k", (2, 128, 1500, 8, 64), False, mesh) == \
        P(None, "data", None, None, None)
    assert dryrun.cache_pspec("blocks/s0/k", (2, 1, 524288, 8, 128), True, mesh) == \
        P(None, None, ("data", "model"), None, None)
