"""Port `Hasher` == reference `Hasher` on every surface, for every family."""
import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, ragged, rng, t32, u32
from repro.hash import Hasher as JHasher
from repro.hash import HashSpec as JSpec
from repro.hash import sharding as jsharding
from repro_torch.hash import Hasher as THasher
from repro_torch.hash import HashSpec as TSpec
from repro_torch.hash import keyring as tkeyring
from repro_torch.hash import sharding as tsharding
from repro_torch.kernels import ops as tops

G = rng(0xA5E)


def _pair(family, out_bits=64, variable_length=True, K=3, max_len=24):
    kw = dict(family=family, n_hashes=K, out_bits=out_bits,
              variable_length=variable_length, seed=0x6F + K)
    return (THasher.from_spec(TSpec(**kw), max_len=max_len, device="cpu"),
            JHasher.from_spec(JSpec(**kw), max_len=max_len))


def _eq(t: torch.Tensor, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("out_bits", [32, 64])
@pytest.mark.parametrize("variable_length", [True, False])
def test_call_matches_reference(family, out_bits, variable_length):
    th, jh = _pair(family, out_bits, variable_length)
    toks = u32(G, (2, 3, 11))  # batch dims are kept
    _eq(th(toks), jh(toks))
    _eq(th(t32(toks.reshape(6, 11))), jh(toks.reshape(6, 11)))
    if variable_length:
        lengths = np.array([0, 1, 11, 6, 7, 2])
        _eq(th(toks.reshape(6, 11), lengths=lengths),
            jh(toks.reshape(6, 11), lengths=lengths))
    else:
        with pytest.raises(ValueError):
            th(toks, lengths=np.ones(6))


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("m", [1, 2**20, 4097, 2**32 - 1, 1_437_758_756])
def test_probe_indices_match_reference(family, m):
    th, jh = _pair(family)
    toks = u32(G, (5, 9))
    lengths = np.array([9, 0, 4, 3, 8])
    _eq(th.probe_indices(toks, m, lengths=lengths),
        jh.probe_indices(toks, m, lengths=lengths))


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_shard_ids_and_bit_planes_match_reference(family):
    th, jh = _pair(family, out_bits=32)
    toks = u32(G, (7, 13))
    for n in (1, 7, 64):
        _eq(th.shard_ids(toks, n), jh.shard_ids(toks, n))
    _eq(th.bit_planes(toks), jh.bit_planes(toks))
    assert th.shard_ids(toks, 64).dtype == torch.int32


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("variable_length", [True, False])
def test_hash_batch_matches_reference(family, variable_length):
    th, jh = _pair(family, max_len=8)  # hash_batch grows past capacity
    items = ragged(G, 9, 40, 1) if variable_length else u32(G, (9, 33))
    want = jh.hash_batch(items, variable_length=variable_length)
    before = tops.launch_count()
    got = th.hash_batch(items, variable_length=variable_length)
    assert tops.launch_count() == before + 1
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        th.hash_batch(items, variable_length=variable_length, backend="host"),
        want)
    got32 = th.hash_batch(items, variable_length=variable_length, out_bits=32)
    assert got32.dtype == np.uint32
    np.testing.assert_array_equal(
        got32, jh.hash_batch(items, variable_length=variable_length,
                             out_bits=32))


def test_hash_batch_edges():
    th, jh = _pair("multilinear_hm")
    items = [np.zeros(0, np.uint32), np.array([5], np.uint32)]
    np.testing.assert_array_equal(th.hash_batch(items), jh.hash_batch(items))
    np.testing.assert_array_equal(th.hash_batch(items, lengths=[0, 0]),
                                  jh.hash_batch(items, lengths=[0, 0]))
    with pytest.raises(ValueError):
        th.hash_batch(items, variable_length=False)
    with pytest.raises(ValueError):
        th.hash_batch(items, backend="jnp")


@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear_hm"])
def test_from_numpy_planes_carries_reference_keys(family):
    """The reference Hasher's planes are the port's weights."""
    jh = JHasher.from_spec(JSpec(family=family, n_hashes=2, out_bits=64,
                                 seed=0xABC), max_len=16)
    th = THasher.from_numpy_planes(np.asarray(jh.key_hi), np.asarray(jh.key_lo),
                                   TSpec(**jh.spec.__dict__), device="cpu")
    toks = u32(G, (4, 10))
    _eq(th(toks), jh(toks))
    np.testing.assert_array_equal(th.hash_batch(toks), jh.hash_batch(toks))
    with pytest.raises(ValueError, match="detached"):
        th.ensure(10_000)


def test_capacity_error_and_ensure():
    th, jh = _pair("multilinear", max_len=8)
    toks = u32(G, (3, 40))
    with pytest.raises(ValueError, match="capacity"):
        th(toks)
    th2, jh2 = th.ensure(40), jh.ensure(40)
    assert th2.capacity == jh2.capacity >= 42
    _eq(th2(toks), jh2(toks))


def test_not_ported_surfaces_raise():
    """`Hasher.sharded`, the last surface this file once found refused, now
    returns a `ShardedHasher` whose hashes are the Hasher's (the full grid
    is in test_torch_distributed.py)."""
    from _torch_port import cpu_mesh
    from repro_torch.hash import ShardedHasher

    th, jh = _pair("multilinear")
    sh = th.sharded(cpu_mesh(3))
    assert isinstance(sh, ShardedHasher) and sh.hasher is th
    toks = u32(G, (5, 11))
    _eq(sh(toks), jh(toks))


def test_default_device_is_cuda_and_never_cpu():
    """With no device= an entry point runs on cuda; without a card it
    raises instead of landing on the CPU."""
    if torch.cuda.is_available():
        assert THasher.from_spec(TSpec()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        THasher.from_spec(TSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkeyring.hasher_for(TSpec())


@pytest.mark.parametrize("salt", [0, 3])
def test_shard_assignment_matches_reference(salt):
    toks = u32(G, (2, 5, 12))
    got = tsharding.shard_assignment(toks, 16, salt=salt, device="cpu")
    np.testing.assert_array_equal(got, jsharding.shard_assignment(toks, 16, salt=salt))
    np.testing.assert_array_equal(
        tsharding.shard_assignment(toks[0, 0], 16, salt=salt, device="cpu"),
        jsharding.shard_assignment(toks[0, 0], 16, salt=salt))
    assert tsharding.salt_spec(salt) == TSpec(**jsharding.salt_spec(salt).__dict__)
    h = u32(G, 50)
    np.testing.assert_array_equal(tsharding.reduce_range(h, 7),
                                  jsharding.reduce_range(h, 7))
