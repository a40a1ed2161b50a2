"""The reference against the port's CPU path at a tiny size, and its
pieces against plain Python integers."""
import math

import numpy as np
import pytest
import torch

from hashbench.harness import program
from hashbench.reference import gf_multilinear, keys, multilinear, probes

FAMILIES = {"multilinear": multilinear, "gf_multilinear": gf_multilinear}
M = 1_437_758_756


def _case(seed, B=23, N=37):
    g = torch.Generator().manual_seed(seed % 2**32)
    toks = torch.randint(-2**31, 2**31, (B, N), generator=g, dtype=torch.int32)
    lens = torch.randint(0, N + 1, (B,), generator=g).to(torch.int32)
    return toks, lens


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [7, 3_000_000_019, 2**40 + 5])
def test_reference_matches_port(family, seed):
    Hasher, HashSpec, _ = program()
    toks, lens = _case(seed)
    N, K = toks.shape[1], 9
    h = Hasher.from_spec(HashSpec(family=family, n_hashes=K, out_bits=64,
                                  seed=seed), max_len=N, device="cpu")
    km = torch.from_numpy(keys.key_matrix(seed, K, N + 2).view(np.int64))
    assert torch.equal(h.keys[:, :N + 2], km)
    ref = FAMILIES[family]
    want = probes.mod_u64(ref.surface(toks, lens, km), M)
    assert torch.equal(h.probe_indices(toks, M, lens), want)
    assert torch.equal(h(toks, lens)[..., 0], ref.hash32(toks, lens, km))


def test_multilinear_by_python_ints():
    toks, lens = _case(11, B=4, N=9)
    km = keys.key_matrix(11, 2, 11)
    got = multilinear.surface(toks, lens, torch.from_numpy(km.view(np.int64)))
    for r in range(4):
        s = [int(x) & 0xFFFFFFFF for x in toks[r, :int(lens[r])]] + [1]
        for k in range(2):
            acc = (int(km[k, 0]) + sum(int(km[k, 1 + i]) * c for i, c in enumerate(s))) % 2**64
            assert int(got[r, k]) % 2**64 == acc


def _clmul(a, b):
    return 0 if not b else ((a if b & 1 else 0) ^ _clmul(a << 1, b >> 1))


def test_gf_by_python_ints():
    toks, lens = _case(13, B=4, N=9)
    km = keys.key_matrix(13, 2, 11)
    got = gf_multilinear.surface(toks, lens, torch.from_numpy(km.view(np.int64)))
    for r in range(4):
        s = [int(x) & 0xFFFFFFFF for x in toks[r, :int(lens[r])]] + [1]
        for k in range(2):
            acc = int(km[k, 0]) & 0xFFFFFFFF
            for i, c in enumerate(s):
                acc ^= _clmul(int(km[k, 1 + i]) & 0xFFFFFFFF, c)
            rem = acc
            for i in range(62, 31, -1):
                if rem >> i & 1:
                    rem ^= gf_multilinear.POLY << (i - 32)
            assert int(got[r, k]) % 2**64 == (rem << 32) | (acc >> 32)


def test_mod_and_bloom_size():
    x = torch.tensor([0, 1, -1, 2**63 - 1, -2**63, 123456789012345], dtype=torch.int64)
    got = probes.mod_u64(x, M).tolist()
    assert got == [(int(v) % 2**64) % M for v in x]
    # the README's filter: k = 9, m ~ 1.44e9
    assert probes.bloom_size(10**8, 1e-3) == (M, 9)
    assert M == int(-10**8 * math.log(1e-3) / math.log(2) ** 2)
