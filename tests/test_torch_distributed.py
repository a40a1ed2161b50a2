"""Port sharded hashing (`hash.distributed.ShardedHasher`, `Hasher.sharded`)
and the mesh routes of TreeHasher, ExactDedup and HashPipeline == the
reference.

The port's mesh is D logical shards of the CPU (`data_mesh(device="cpu",
n_shards=D)`); the reference runs on its own one-device `data_mesh()` in
this process (no subprocess). Every comparison is exact equality.
"""
import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, cpu_mesh, ragged, rng, t32, u32
from repro.data import ExactDedup as JExact
from repro.data import HashPipeline as JPipe
from repro.data import PipelineConfig as JCfg
from repro.hash import Hasher as JHasher
from repro.hash import HashSpec as JSpec
from repro.hash import tree as jtree
from repro.parallel.sharding import data_mesh as jmesh
from repro_torch.data import ExactDedup as TExact
from repro_torch.data import HashPipeline as TPipe
from repro_torch.data import PipelineConfig as TCfg
from repro_torch.data import synthetic as tsyn
from repro_torch.hash import Hasher as THasher
from repro_torch.hash import HashSpec as TSpec
from repro_torch.hash import ShardedHasher
from repro_torch.hash import tree as ttree
from repro_torch.kernels import ops as tops
from repro_torch.parallel import Mesh, data_mesh, home_device, mesh_axis_size

SHARDS = [1, 2, 3, 8]


def _inputs(ragged_rows: bool):
    """11 rows (not a multiple of any D above 1): ragged lengths 0..19, or
    a dense (11, 17) batch."""
    g = rng(0xD157 + ragged_rows)
    return ragged(g, 11, 19) if ragged_rows else u32(g, (11, 17))


def _spec_kw(family, ragged_rows, out_bits):
    return dict(family=family, n_hashes=3, out_bits=out_bits,
                variable_length=ragged_rows, seed=0xD15)


def _launches(D, fn):
    before = tops.launch_count()
    out = fn()
    assert tops.launch_count() == before + D
    return out


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference `Hasher.sharded(data_mesh()).hash_batch` of the ragged
    64-bit case, per family (one trace each)."""
    cache = {}

    def get(family):
        if family not in cache:
            jh = JHasher.from_spec(JSpec(**_spec_kw(family, True, 64)),
                                   max_len=24)
            cache[family] = jh.sharded(jmesh()).hash_batch(_inputs(True))
        return cache[family]
    return get


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("out_bits", [32, 64])
@pytest.mark.parametrize("ragged_rows", [False, True])
@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_sharded_hash_batch_matches_reference(family, ragged_rows, out_bits,
                                              D, ref_sharded):
    kw = _spec_kw(family, ragged_rows, out_bits)
    x = _inputs(ragged_rows)
    jh = JHasher.from_spec(JSpec(**kw), max_len=24)
    sh = THasher.from_spec(TSpec(**kw), max_len=24, device="cpu").sharded(
        cpu_mesh(D))
    assert isinstance(sh, ShardedHasher) and sh.n_shards == D
    got = _launches(D, lambda: sh.hash_batch(x))
    want = jh.hash_batch(x, backend="host")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the widened output (over a 32-bit spec: the cached 64-bit twin)
    wide = _launches(D, lambda: sh.hash_batch(x, out_bits=64))
    np.testing.assert_array_equal(
        wide, jh.hash_batch(x, out_bits=64, backend="host"))
    np.testing.assert_array_equal(sh.hash_batch(x, out_bits=32),
                                  jh.hash_batch(x, out_bits=32, backend="host"))
    if ragged_rows and out_bits == 64:
        np.testing.assert_array_equal(got, ref_sharded(family))


@pytest.fixture(scope="module")
def ref_surfaces():
    """Reference `Hasher` tensor surfaces per family: (tokens, __call__,
    shard_ids(13), probe_indices(4097), and with lengths)."""
    cache = {}

    def get(family):
        if family not in cache:
            g = rng(0xD16)
            toks = u32(g, (6, 17))
            lens = np.array([0, 1, 17, 16, 5, 9], np.int32)
            jh = JHasher.from_spec(JSpec(family=family, n_hashes=2, out_bits=64,
                                         variable_length=True, seed=0xD16),
                                   max_len=24)
            cache[family] = (toks, lens, np.asarray(jh(toks)),
                             np.asarray(jh.shard_ids(toks, 13)),
                             np.asarray(jh.probe_indices(toks, 4097)),
                             np.asarray(jh(toks, lens)),
                             np.asarray(jh.probe_indices(toks, 2**20, lens)))
        return cache[family]
    return get


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("family", ["multilinear_hm", "gf_multilinear"])
def test_sharded_tensor_surfaces_match_reference(family, D, ref_surfaces):
    toks, lens, call, ids, probes, call_l, probes_l = ref_surfaces(family)
    th = THasher.from_spec(TSpec(family=family, n_hashes=2, out_bits=64,
                                 variable_length=True, seed=0xD16),
                           max_len=24, device="cpu")
    sh = th.sharded(cpu_mesh(D))
    t = t32(toks)
    for got, want in (
            (_launches(D, lambda: sh(t)), call),
            (_launches(D, lambda: sh.shard_ids(t, 13)), ids),
            (_launches(D, lambda: sh.probe_indices(t, 4097)), probes),
            (_launches(D, lambda: sh(t, lens)), call_l),
            (_launches(D, lambda: sh.probe_indices(t, 2**20, lens)), probes_l)):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a batch of more than one leading dim keeps its shape
    t3 = t.reshape(2, 3, 17)
    assert torch.equal(sh(t3), th(t3))
    assert torch.equal(sh.shard_ids(t3, 5), th.shard_ids(t3, 5))
    assert tuple(sh.probe_indices(t3, 7).shape) == (2, 3, 2)


@pytest.mark.parametrize("D", [1, 3])
def test_sharded_capacity_growth(D):
    kw = dict(family="multilinear", n_hashes=2, out_bits=64, seed=0xD17)
    th = THasher.from_spec(TSpec(**kw), max_len=8, device="cpu")
    jh = JHasher.from_spec(JSpec(**kw), max_len=8)
    sh = th.sharded(cpu_mesh(D))
    toks = u32(rng(0xD17), (5, 40))
    with pytest.raises(ValueError, match="capacity"):
        sh(toks)
    assert sh.ensure(40) is sh and sh.hasher.capacity >= 42
    np.testing.assert_array_equal(sh(toks).numpy(),
                                  np.asarray(jh.ensure(40)(toks)).astype(np.int64))
    # hash_batch grows the keys itself for wider ragged rows
    items = ragged(rng(0xD18), 7, 300, min_len=250)
    tv = THasher.from_spec(TSpec(**kw, variable_length=True), max_len=8,
                           device="cpu").sharded(cpu_mesh(D))
    jv = JHasher.from_spec(JSpec(**kw, variable_length=True), max_len=8)
    np.testing.assert_array_equal(tv.hash_batch(items),
                                  jv.hash_batch(items, backend="host"))
    assert tv.hasher.capacity >= 302


def test_mesh_and_missing_axis():
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis_names == ("data",)
    assert mesh == cpu_mesh(4) and hash(mesh) == hash(cpu_mesh(4))
    assert mesh_axis_size(mesh, "data") == 4
    assert mesh_axis_size(mesh, "model") == 1
    assert data_mesh(device="cpu") == Mesh((torch.device("cpu"),))
    assert home_device(mesh) == torch.device("cpu")
    th = THasher.from_spec(TSpec(), device="cpu")
    with pytest.raises(ValueError, match="no 'model'"):
        ShardedHasher(th, mesh, axis="model")
    with pytest.raises(ValueError, match="n_shards"):
        data_mesh(device="cpu", n_shards=0)
    with pytest.raises(ValueError):
        Mesh(())
    # a Hasher off the card defaults to a mesh of its own device
    assert th.sharded().mesh == data_mesh(device="cpu")


def test_data_mesh_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        assert data_mesh().size == torch.cuda.device_count()
        assert data_mesh(n_shards=3).devices == (data_mesh().devices[0],) * 3
        return
    for fn in (data_mesh, lambda: data_mesh(n_shards=2),
               lambda: home_device(None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


TOKS123 = (np.arange(123, dtype=np.uint32) * np.uint32(2654435761)) ^ np.uint32(0x9E37)


@pytest.mark.parametrize("D", SHARDS)
def test_tree_mesh_routes_match_reference(D):
    spec = ttree.TreeSpec(leaf_words=8)
    th = ttree.TreeHasher(spec, mesh=cpu_mesh(D))
    assert th.device == torch.device("cpu") and th.sharded.n_shards == D
    fp = _launches(D, lambda: th.fingerprint(TOKS123))
    assert fp == 0x82F15E0BB5AF2B2B
    assert fp == jtree.TreeHasher(jtree.TreeSpec(leaf_words=8)).fingerprint(TOKS123)
    assert fp == th.digest_host(TOKS123)
    # a stream over the mesh, split anyhow
    st = ttree.stream_tree(spec, mesh=cpu_mesh(D), leaf_batch=3)
    for a, b in ((0, 5), (5, 60), (60, 123)):
        st.update(TOKS123[a:b])
    assert st.digest_int() == fp
    assert ttree.default_tree_hasher(spec, mesh=cpu_mesh(D)) is \
        ttree.default_tree_hasher(spec, mesh=cpu_mesh(D))
    assert ttree.default_tree_hasher(spec, mesh=cpu_mesh(D)) is not \
        ttree.default_tree_hasher(spec, device="cpu")
    tree = {"w": np.arange(40, dtype=np.float32).reshape(5, 8),
            "b": [np.ones(3, np.int32), np.zeros((2, 2), np.uint8)]}
    got = ttree.fingerprint_pytree(tree, mesh=cpu_mesh(D))
    want = jtree.fingerprint_pytree(tree)
    assert (got.root, got.leaves) == (want.root, want.leaves)


@pytest.mark.parametrize("D", [2, 3])
def test_exact_dedup_mesh_matches_reference(D):
    g = rng(0xE5)
    items = ragged(g, 30, 25)
    items += [items[i] for i in g.integers(0, 30, 12)]
    t, j = TExact(mesh=cpu_mesh(D)), JExact()
    assert t.hasher.device == torch.device("cpu")
    got = _launches(D, lambda: t.check_and_add_batch(items))
    np.testing.assert_array_equal(got, j.check_and_add_batch(items))
    docs = items[:4] + [np.arange(5000, dtype=np.uint32)] + ragged(g, 5, 10)
    np.testing.assert_array_equal(t.add_documents(docs), j.add_documents(docs))
    assert t.seen == j.seen
    assert t._tree_hasher().sharded.n_shards == D


@pytest.mark.parametrize("D", [2, 3])
def test_pipeline_mesh_matches_reference(D):
    cfg = dict(seq_len=16, batch_size=2, eval_pct=20, n_shards=3, shard_id=1)
    t, j = TPipe(TCfg(**cfg), mesh=cpu_mesh(D)), JPipe(JCfg(**cfg))
    assert t.device == torch.device("cpu")
    docs = list(tsyn.corpus(3, 30, 1000, doc_len=(4, 40)))
    docs += docs[:6]
    assert _launches(D, lambda: t.admit_batch(docs)) == j.admit_batch(docs)
    assert [t.admit(d) for d in docs[:5]] == [j.admit(d) for d in docs[:5]]
    assert t.stats == j.stats
