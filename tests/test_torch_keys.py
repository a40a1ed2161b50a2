"""Port keys/spec/keyring == reference: identical Philox key planes."""
import numpy as np
import pytest

from repro.core import keys as jkeys
from repro.hash import Hasher as JHasher
from repro.hash import HashSpec as JSpec
from repro.hash import keyring as jkeyring
from repro.hash import spec as jspec
from repro_torch.core import keys as tkeys
from repro_torch.hash import Hasher as THasher
from repro_torch.hash import HashSpec as TSpec
from repro_torch.hash import keyring as tkeyring
from repro_torch.hash import spec as tspec


def _planes(h: THasher):
    k = h.keys.numpy().view(np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 0x5EED, 2**64 - 1])
@pytest.mark.parametrize("start,count", [(0, 1), (0, 9), (3, 17), (1021, 70)])
def test_generate_keys_u64(seed, start, count):
    np.testing.assert_array_equal(tkeys.generate_keys_u64(seed, start, count),
                                  jkeys.generate_keys_u64(seed, start, count))


@pytest.mark.parametrize("seed", [0x5EED, 0xCAFE, 7])
@pytest.mark.parametrize("K", [1, 3, 9])
def test_multikey_planes_and_growth(seed, K):
    t = tkeys.MultiKeyBuffer(seed=seed, n_hashes=K, initial=16)
    j = jkeys.MultiKeyBuffer(seed=seed, n_hashes=K, initial=16)
    for n in (5, 16, 17, 300):  # widths past `initial` grow by ensure
        np.testing.assert_array_equal(t.stacked_u64(n), j.stacked_u64(n))
        for a, b in zip(t.planes(n), j.planes(n)):
            np.testing.assert_array_equal(a, b)
    assert t.seeds == j.seeds
    assert tkeys._GOLDEN64 == jkeys._GOLDEN64
    assert all(tkeys.derive_stream_seed(seed, i) == jkeys.derive_stream_seed(seed, i)
               for i in range(K))


@pytest.mark.parametrize("seed", [jspec.DEFAULT_SEED, 0x6F, (1, 2, 3)])
def test_stream_seeds(seed):
    n = len(seed) if isinstance(seed, tuple) else 4
    assert (TSpec(n_hashes=n, seed=seed).stream_seeds()
            == JSpec(n_hashes=n, seed=seed).stream_seeds())


def test_family_tables_and_spec_validation():
    assert tspec.FAMILY_NAMES == jspec.FAMILY_NAMES
    assert tspec.FAMILIES == {k: tspec.FamilyTraits(**v.__dict__)
                              for k, v in jspec.FAMILIES.items()}
    assert tspec.DEFAULT_SEED == jspec.DEFAULT_SEED
    for bad in ({"family": "nope"}, {"n_hashes": 0}, {"out_bits": 16},
                {"n_hashes": 2, "seed": (1,)}):
        with pytest.raises((KeyError, ValueError)):
            TSpec(**bad)


@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear_hm"])
@pytest.mark.parametrize("K,max_len", [(1, 3), (4, 100), (9, 256)])
def test_hasher_planes_match_and_grow(family, K, max_len):
    spec_kw = dict(family=family, n_hashes=K, seed=0x1234 + K)
    t = THasher.from_spec(TSpec(**spec_kw), max_len=max_len, device="cpu")
    j = JHasher.from_spec(JSpec(**spec_kw), max_len=max_len)
    assert t.capacity == j.capacity
    for a, b in zip(_planes(t), (np.asarray(j.key_hi), np.asarray(j.key_lo))):
        np.testing.assert_array_equal(a, b)
    t2, j2 = t.ensure(3 * max_len), j.ensure(3 * max_len)
    assert t2.capacity == j2.capacity > t.capacity
    for a, b in zip(_planes(t2), (np.asarray(j2.key_hi), np.asarray(j2.key_lo))):
        np.testing.assert_array_equal(a, b)
    assert t.ensure(max_len) is t


def test_keyring_defaults_match():
    tkeyring.clear()
    np.testing.assert_array_equal(tkeyring.key_buffer(0x77).u64(40),
                                  jkeyring.key_buffer(0x77).u64(40))
    spec = TSpec(n_hashes=2, seed=0x99)
    h = tkeyring.hasher_for(spec, max_len=8, device="cpu")
    assert tkeyring.hasher_for(spec, max_len=8, device="cpu") is h
    wide = tkeyring.hasher_for(spec, max_len=500, device="cpu")
    assert wide.capacity >= 502
    jh = jkeyring.hasher_for(JSpec(n_hashes=2, seed=0x99), max_len=500)
    np.testing.assert_array_equal(_planes(wide)[1], np.asarray(jh.key_lo))
    tkeyring.clear()
