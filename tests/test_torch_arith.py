"""Port int64 tensor arithmetic == reference limb arithmetic, bit for bit.

Grid of tests/test_limbs_mod.py: m = 1, powers of two, 4097, 2^32-1 and
more; h = 0 and 2^64-1 among the edges.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng, u32
from repro.core import gf as jgf
from repro.core import hostref as jhost
from repro.core import limbs as jlimbs
from repro_torch.core import gf as tgf
from repro_torch.core import hostref as thost
from repro_torch.core import limbs as tlimbs

G = rng(0x60D)
EDGE_H = np.array([0, 1, 2, 2**16, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
                   2**48, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1], np.uint64)
EDGE_M = [1, 2, 3, 4, 5, 7, 64, 4097, 2**16 - 1, 2**16, 2**16 + 1, 2**20,
          2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]
EDGE_32 = np.array([0, 1, 2, 0xC5, 2**16, 2**31 - 1, 2**31, 2**32 - 1],
                   np.uint32)


def _h():
    return np.concatenate([G.integers(0, 2**64, 512, dtype=np.uint64), EDGE_H])


def _t64(a):
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64).copy())


@pytest.mark.parametrize("m", EDGE_M)
def test_mod_u64_matches_reference(m):
    h = _h()
    got = tlimbs.mod_u64(_t64(h), tlimbs.ModPlan.for_modulus(m)).numpy()
    hi = (h >> np.uint64(32)).astype(np.uint32)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ref = np.asarray(jlimbs.mod_u64((hi, lo), jlimbs.ModPlan.for_modulus(m)))
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    np.testing.assert_array_equal(got, (h % np.uint64(m)).astype(np.int64))
    np.testing.assert_array_equal(thost.mod_u64_np(h, m), ref)
    assert tlimbs.ModPlan.for_modulus(m).is_pow2 == jlimbs.ModPlan.for_modulus(m).is_pow2


def test_mod_plan_rejects_out_of_domain():
    for m in (0, -1, 2**32):
        with pytest.raises(ValueError):
            tlimbs.ModPlan.for_modulus(m)


def _operands():
    a = np.concatenate([u32(G, 256), EDGE_32, np.repeat(EDGE_32, len(EDGE_32))])
    b = np.concatenate([u32(G, 256), EDGE_32, np.tile(EDGE_32, len(EDGE_32))])
    return a, b


def test_clmul32_matches_reference():
    a, b = _operands()
    got = tgf.clmul32(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64))).numpy()
    hi, lo = (np.asarray(x) for x in jgf.clmul32(jnp.asarray(a), jnp.asarray(b)))
    want = (hi.astype(np.uint64) << np.uint64(32)) | lo
    np.testing.assert_array_equal(got.view(np.uint64), want)
    np.testing.assert_array_equal(
        got[:8], [jgf.clmul_ref(int(x), int(y)) for x, y in zip(a[:8], b[:8])])


def test_barrett_reduce_matches_reference():
    a, b = _operands()
    acc = tgf.clmul32(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64)))
    got = tgf.barrett_reduce(acc).numpy()
    hi, lo = jgf.clmul32(jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(jgf.barrett_reduce(hi, lo))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert tgf.POLY_LOW == jgf.POLY_LOW
    accs = acc.numpy().view(np.uint64)
    np.testing.assert_array_equal(got, jhost._gf_barrett_np(accs).astype(np.int64))
    assert all(int(r) == jgf.poly_mod_ref(int(q)) for r, q in zip(got[:16], accs[:16]))


def test_mulhi32_and_bit_planes_match_reference():
    a = np.concatenate([u32(G, 128), EDGE_32])
    ta = torch.from_numpy(a.astype(np.int64))
    for n in (1, 3, 64, 1000, 2**31 - 1):
        hi, _ = jlimbs.mul32_full(jnp.asarray(a), jnp.uint32(n))
        np.testing.assert_array_equal(tlimbs.mulhi32(ta, n).numpy(),
                                      np.asarray(hi).astype(np.int64))
    with pytest.raises(ValueError):
        tlimbs.mulhi32(ta, 2**31)
    np.testing.assert_array_equal(tlimbs.unpack_bits32(ta).numpy(),
                                  np.asarray(jlimbs.unpack_bits32(jnp.asarray(a))))


@pytest.mark.parametrize("variable_length,lengths", [
    (False, None), (True, None), (True, [0, 5, 9, 1])])
def test_encode_lengths_matches_reference(variable_length, lengths):
    np.testing.assert_array_equal(
        thost.encode_lengths(lengths, 9, variable_length, 4),
        jhost.encode_lengths(lengths, 9, variable_length, 4))


@pytest.mark.parametrize("family", ["multilinear", "multilinear_2x2",
                                    "multilinear_hm", "gf_multilinear",
                                    "gf_multilinear_hm"])
def test_host_twins_match_reference(family):
    toks = u32(G, (7, 16))
    lens = np.array([0, 1, 15, -17, -1, 7, 14], np.int32)
    keys = G.integers(0, 2**64, (3, 17), dtype=np.uint64)
    if family.startswith("gf"):
        k32 = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        got = thost.gf_multilinear_multi_np(toks, lens, k32, family=family)
        want = jhost.gf_multilinear_multi_np(toks, lens, k32, family=family)
    else:
        got = thost.multilinear_multi_np(toks, lens, keys, family=family)
        want = jhost.multilinear_multi_np(toks, lens, keys, family=family)
    np.testing.assert_array_equal(got, want)
