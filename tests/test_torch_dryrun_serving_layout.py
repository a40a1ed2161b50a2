"""The serving layout of the dry run's prefill cells (no JAX): smoke
mistral_nemo_12b and granite_moe_hash on fake worlds, a prefill of
T = 4 x attn_chunk_k tokens (and rwkv6 and jamba, 32 tokens, for their
states).

Sequence-parallel prefill bounds a rank's temporaries: on a (1, 4) world
the census's temp a rank is at most 0.4 of a one-rank world's (each
model rank holds a quarter of the stream and of the query rows, and so
a quarter of each f32 score tile). Each rank's caches are
its chunks at `cache_pspec` (S over "model", over data + model when
B = 1; Mamba and RWKV states by channel or head), and its logits are its
rows with every column.
"""
import functools

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.launch import dryrun
from repro_torch.parallel import Mesh
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.fake_world import fake_world

CPU = torch.device("cpu")
ARCHS = ["mistral_nemo_12b", "granite_moe_hash"]
TEMP_RATIO = 0.4


def _mesh(dims):
    return Mesh((CPU,) * (dims[0] * dims[1]), ("data", "model"), dims)


# the state-space families' chunked scans run slowly on fake tensors: a
# short prefill shows their states' chunks
SHORT = {"rwkv6_1_6b": 32, "jamba_v0_1_52b": 32}


def _shape(arch: str, cfg, B: int) -> ShapeSpec:
    return ShapeSpec("prefill_4k", "prefill", SHORT.get(arch, 4 * cfg.attn_chunk_k), B)


@functools.lru_cache(maxsize=None)
def _temp(arch: str, dims: tuple) -> int:
    cfg = get_config(arch, smoke=True)
    rec = dryrun.run_cell(arch, "prefill_4k", "w", mesh=_mesh(dims), shape=_shape(arch, cfg, 2),
                          cfg=cfg, device="cpu")
    return rec["memory"]["temp_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_temp_a_rank_shrinks_with_the_model_ranks(arch):
    one, four = _temp(arch, (1, 1)), _temp(arch, (1, 4))
    assert 0 < four <= TEMP_RATIO * one, (four, one)


@pytest.mark.parametrize("dims,B", [((1, 4), 2), ((2, 2), 4), ((2, 2), 1)])
@pytest.mark.parametrize("arch", ARCHS + ["rwkv6_1_6b", "jamba_v0_1_52b"])
def test_prefill_caches_are_the_ranks_chunks(arch, dims, B):
    cfg = get_config(arch, smoke=True)
    shape = _shape(arch, cfg, B)
    mesh = _mesh(dims)
    with fake_world(mesh), FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, _ = dryrun.build_cell(arch, shape, mesh, device=CPU, cfg=cfg)
        logits, caches = fn(*args)
        rows = B if B % dims[0] else B // dims[0]
        assert tuple(logits.shape) == (rows, cfg.vocab_size)
        whole = dict(flatten_with_paths(dryrun.cache_shapes(cfg, B, shape.seq_len)))
        got = dict(flatten_with_paths(caches))
        assert set(got) == set(whole)
        for path, t in got.items():
            spec = sh.cache_pspec(path, whole[path].shape, B == 1, mesh)
            want = sh.NamedSharding(mesh, spec).local_shape(tuple(whole[path].shape))
            assert tuple(t.shape) == want, (path, spec)
            assert t.dtype == whole[path].dtype, path


def test_census_counts_no_memory_for_meta_tensors():
    """A prefill reads its whole caches' shapes as meta tensors; they hold
    no memory, so the census's peak is the rank's own tensors."""
    from repro_torch.launch.op_analysis import Census

    with Census() as c:
        shapes = torch.zeros(1 << 20, 1 << 20, device="meta").clone()
        real = torch.zeros(1024)
    assert shapes.shape[0] == 1 << 20
    assert c.totals()["peak_bytes"] == real.numel() * 4
