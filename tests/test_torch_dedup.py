"""Port Bloom/dedup/pipeline admission == the reference, verdict for verdict."""
import numpy as np
import pytest

from _torch_port import ENGINE_FAMILIES, cpu_mesh, ragged, rng
from repro.data import BloomFilter as JBloom
from repro.data import ExactDedup as JExact
from repro.data import HashPipeline as JPipe
from repro.data import PipelineConfig as JCfg
from repro.data import synthetic as jsyn
from repro_torch.data import BloomFilter as TBloom
from repro_torch.data import ExactDedup as TExact
from repro_torch.data import HashPipeline as TPipe
from repro_torch.data import PipelineConfig as TCfg
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops


def _stream(seed, n=40):
    """Items with in-batch duplicates and repeats of earlier batches."""
    g = rng(seed)
    items = ragged(g, n, 30)
    return items + [items[i] for i in g.integers(0, n, n // 2)]


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_bloom_bits_and_verdicts_match_reference(family):
    items = _stream(0xB1)
    t = TBloom(n_items=200, fp_rate=1e-2, family=family, device="cpu")
    j = JBloom(n_items=200, fp_rate=1e-2, family=family)
    assert (t.m, t.k) == (j.m, j.k)
    t.add_batch(items[:10]), j.add_batch(items[:10])
    np.testing.assert_array_equal(t.bits, j.bits)
    before = tops.launch_count()
    np.testing.assert_array_equal(t.check_and_add_batch(items[10:]),
                                  j.check_and_add_batch(items[10:]))
    assert tops.launch_count() == before + 1
    np.testing.assert_array_equal(t.bits, j.bits)
    probe = items[::3] + ragged(rng(5), 10, 12)
    np.testing.assert_array_equal(t.contains_batch(probe), j.contains_batch(probe))
    t.add(probe[-1]), j.add(probe[-1])
    assert (probe[-1] in t) and (probe[-1] in j)
    assert [x in t for x in probe] == [x in j for x in probe]
    np.testing.assert_array_equal(t.bits, j.bits)
    assert len(t.check_and_add_batch([])) == 0


@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear_hm"])
def test_bloom_crowded_filter_arrival_order(family):
    """A tiny filter (m = 64) makes most items share bits, so nearly every
    verdict goes through the sequential arrival-order path."""
    items = _stream(0xC2, 60)
    t = TBloom(n_items=8, fp_rate=0.3, family=family, device="cpu")
    j = JBloom(n_items=8, fp_rate=0.3, family=family)
    assert (t.m, t.k) == (64, 5)
    for lo, hi in ((0, 30), (30, 90)):
        np.testing.assert_array_equal(t.check_and_add_batch(items[lo:hi]),
                                      j.check_and_add_batch(items[lo:hi]))
        np.testing.assert_array_equal(t.bits, j.bits)


def test_bloom_load_bits_takes_reference_words():
    items = _stream(0xD3)
    j = JBloom(n_items=300, fp_rate=1e-3)
    j.add_batch(items[:25])
    t = TBloom(n_items=300, fp_rate=1e-3, device="cpu")
    t.load_bits(j.bits)
    np.testing.assert_array_equal(t.contains_batch(items), j.contains_batch(items))
    np.testing.assert_array_equal(t.check_and_add_batch(items),
                                  j.check_and_add_batch(items))
    with pytest.raises(ValueError):
        t.load_bits(j.bits[:-1])


def test_exact_dedup_matches_reference():
    items = _stream(0xE4)
    t, j = TExact(device="cpu"), JExact()
    assert [t.check_and_add(x) for x in items[:5]] == [j.check_and_add(x)
                                                       for x in items[:5]]
    before = tops.launch_count()
    np.testing.assert_array_equal(t.check_and_add_batch(items[5:]),
                                  j.check_and_add_batch(items[5:]))
    assert tops.launch_count() == before + 1
    docs = ragged(rng(9), 6, 20) + items[:3]
    np.testing.assert_array_equal(t.add_documents(docs), j.add_documents(docs))
    assert t.seen == j.seen
    long = [np.zeros(5000, np.uint32), docs[0], np.zeros(5000, np.uint32)]
    np.testing.assert_array_equal(t.add_documents(long), j.add_documents(long))
    assert t.seen == j.seen
    # mesh= and approx_items=, once refused: the same verdicts here
    sharded = TExact(mesh=cpu_mesh(2))
    np.testing.assert_array_equal(sharded.check_and_add_batch(items),
                                  JExact().check_and_add_batch(items))
    approx = TExact(device="cpu", approx_items=1000)
    assert approx._bloom.n_shards == 1 and approx._bloom.k == 9
    distinct = ragged(rng(10), 8, 20, min_len=1)
    assert approx.check_and_add_batch(distinct).all()
    assert not approx.check_and_add_batch(distinct).any()


def test_pipeline_routes_match_reference():
    cfg = dict(seq_len=16, batch_size=2, eval_pct=20, n_shards=3, shard_id=1)
    t, j = TPipe(TCfg(**cfg), device="cpu"), JPipe(JCfg(**cfg))
    docs = list(tsyn.corpus(3, 30, 1000, doc_len=(4, 40)))
    before = tops.launch_count()
    assert t.admit_batch(docs[:20]) == j.admit_batch(docs[:20])
    assert tops.launch_count() == before + 1
    assert [t.admit(d) for d in docs[20:]] == [j.admit(d) for d in docs[20:]]
    assert t.stats == j.stats
    h = np.arange(1, 30, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(t.epoch_order(h, 2), j.epoch_order(h, 2))
    tp, jp = TPipe(TCfg(**cfg), device="cpu"), JPipe(JCfg(**cfg))
    for a, b in zip(tp.pack(iter(docs)), jp.pack(iter(docs))):
        for key in ("tokens", "labels", "mask"):
            np.testing.assert_array_equal(a[key], b[key])
    # mesh= and admission=, once refused: the same routes here
    from repro_torch.hash import AdmissionService

    svc = AdmissionService.over_bloom_shards(2, 4096, device="cpu")
    for kw in ({"mesh": cpu_mesh(2)}, {"admission": svc}):
        assert TPipe(TCfg(**cfg), device="cpu", **kw).admit_batch(docs[:20]) == \
            JPipe(JCfg(**cfg)).admit_batch(docs[:20])


def test_synthetic_corpus_matches_reference():
    for a, b in zip(tsyn.corpus(11, 25, 500), jsyn.corpus(11, 25, 500)):
        np.testing.assert_array_equal(a, b)
