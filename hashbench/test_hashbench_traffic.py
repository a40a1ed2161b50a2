"""The general generator: shapes, length bounds and determinism from the
seed, on the real traffic files cut to a tiny pool."""
import json

import numpy as np
import pytest
import torch

from hashbench import generator
from hashbench.conftest import HERE, tiny_traffic

SEED = 3_000_000_019  # above 2**31, as the driver's seeds are


@pytest.mark.parametrize("name", ["docs", "keys"])
def test_pool_shapes_and_bounds(name, cpu):
    t = tiny_traffic(name)
    pool = generator.make_pool(t, SEED, cpu)
    P, B, N = t["batches"], t["rows"], t["max_tokens"]
    assert pool.tokens.shape == (P, B, N) and pool.tokens.dtype == torch.int32
    assert pool.lengths.shape == (P, B) and pool.lengths.dtype == torch.int32
    assert np.array_equal(pool.lengths.numpy(), pool.lengths_host)
    lo, hi = generator.bounds(t["lengths"])
    assert pool.lengths_host.min() >= lo and pool.lengths_host.max() <= hi
    assert int(pool.tokens.min()) >= 0 and int(pool.tokens.max()) < t["vocab"]


@pytest.mark.parametrize("name", ["docs", "keys"])
def test_pool_from_the_seed(name, cpu):
    t = tiny_traffic(name)
    a, b = (generator.make_pool(t, SEED, cpu) for _ in range(2))
    c = generator.make_pool(t, SEED + 1, cpu)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
    assert not torch.equal(a.tokens, c.tokens)
    lo, hi = generator.bounds(t["lengths"])
    assert np.array_equal(a.lengths_host, c.lengths_host) == (lo == hi)
    # every seed the same multiset of lengths, in another order
    assert np.array_equal(np.sort(a.lengths_host, None), np.sort(c.lengths_host, None))


@pytest.mark.parametrize("name,live_mtokens", [("docs", 41.59), ("keys", 13.63)])
def test_full_size_lengths(name, live_mtokens):
    """The real mixes' lengths: each source's share of the rows, and the
    live tokens a batch (the pool's whole draw over its batches)."""
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    n = t["batches"] * t["rows"]
    L = generator.quantile_lengths(t["lengths"], n)
    assert float(L.sum()) / t["batches"] / 1e6 == pytest.approx(live_mtokens, abs=0.005)
    if t["lengths"]["kind"] == "sources":
        docs = np.array([s["documents_M"] for s in t["lengths"]["sources"]])
        rows = generator.source_rows(t["lengths"]["sources"], n)
        assert rows.sum() == n and np.all(np.abs(rows - n * docs / docs.sum()) < 1)
    # a batch's tokens are above the card's 50 MB L2
    assert 4 * t["rows"] * t["max_tokens"] > 50e6


@pytest.mark.parametrize("dist", [
    {"kind": "sources", "min": 1, "max": 10**6,
     "sources": [{"documents_M": 3, "tokens_B": 3}, {"documents_M": 1, "tokens_B": 0.1}]},
    {"kind": "fixed", "tokens": 13},
])
def test_quantile_lengths(dist):
    L = generator.quantile_lengths(dist, 4001)
    lo, hi = generator.bounds(dist)
    assert len(L) == 4001 and int(L.min()) >= lo and int(L.max()) <= hi
    if dist["kind"] == "fixed":
        assert bool((L == 13).all())
        return
    # 3,000.75 and 1,000.25 rows: the larger remainder takes the odd row;
    # each source's quantiles ascend and keep its mean, 1,000 and 100
    a, b = L[:3001].double(), L[3001:].double()
    assert bool((a[1:] >= a[:-1]).all()) and bool((b[1:] >= b[:-1]).all())
    assert float(a.mean()) == pytest.approx(1000, rel=0.01)
    assert float(b.mean()) == pytest.approx(100, rel=0.01)
