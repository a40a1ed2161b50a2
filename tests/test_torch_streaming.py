"""Port streaming fingerprints == reference: `Hasher.stream/update/digest/
digest_int`, `stream_digest_host` and `fingerprint_bytes` (exact equality),
and the same exception types at the stream's limits."""
import re

import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, rng, t32, u32
from repro.hash import Hasher as JHasher
from repro.hash import HashSpec as JSpec
from repro.hash import fingerprint_bytes as j_fingerprint_bytes
from repro.hash import stream_digest_host as j_digest_host
from repro.hash.streaming import level2_seed as j_level2_seed
from repro_torch.hash import Hasher as THasher
from repro_torch.hash import HashSpec as TSpec
from repro_torch.hash import fingerprint_bytes as t_fingerprint_bytes
from repro_torch.hash import stream_digest_host as t_digest_host
from repro_torch.hash.streaming import level2_seed as t_level2_seed

G = rng(0x57E)
TOKS = u32(G, 200)


def _pair(family="multilinear", K=1, seed=0x5EA, max_len=16):
    kw = dict(family=family, n_hashes=K, out_bits=64, seed=seed)
    return (THasher.from_spec(TSpec(**kw), max_len=max_len, device="cpu"),
            JHasher.from_spec(JSpec(**kw), max_len=max_len))


def _absorb(h, toks, bounds, chunk_words=16, max_chunks=64):
    st = h.stream(chunk_words=chunk_words, max_chunks=max_chunks)
    for a, b in zip(bounds[:-1], bounds[1:]):
        st = h.update(st, toks[a:b])
    return st


@pytest.mark.parametrize("bounds", [
    [0, 200], [0, 5, 5, 37, 77, 200], [0, 1, 16, 17, 48, 199, 200],
    [0, 64, 128, 192, 200], [0, 15, 200]],
    ids=["one", "straddle", "edges", "whole-chunks", "tail"])
def test_stream_digest_matches_reference(bounds):
    th, jh = _pair()
    ts, js = _absorb(th, TOKS, bounds), _absorb(jh, TOKS, bounds)
    assert th.digest_int(ts) == jh.digest_int(js)
    np.testing.assert_array_equal(th.digest(ts).numpy(),
                                  np.asarray(jh.digest(js)).astype(np.int64))
    assert (ts.fill, ts.count) == (int(js.fill), int(js.count))
    np.testing.assert_array_equal(ts.buf.numpy().view(np.uint32),
                                  np.asarray(js.buf))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 16, 24])
def test_stream_boundary_goldens(n):
    """The reference's pinned edge digests (tests/test_hasher.py): the
    port's host reference and its incremental stream both reproduce them."""
    golden = {0: 0x8B947ECE848198CF, 1: 0xC9D3E6FDAE306EC2,
              7: 0x3003619143E6DBA8, 8: 0x94170584BBD7799B,
              16: 0x5D2387D4D9BFC4D5, 24: 0x1BD231C97E7F4BAA}
    th, jh = _pair(seed=0xAB, max_len=8)
    toks = (np.arange(123, dtype=np.uint32) * np.uint32(2654435761)) \
        ^ np.uint32(0x9E37)
    assert t_digest_host(th, toks[:n], 8, max_chunks=3) == golden[n]
    assert j_digest_host(jh, toks[:n], 8, max_chunks=3) == golden[n]
    st = th.update(th.stream(chunk_words=8, max_chunks=3), t32(toks[:n]))
    assert th.digest_int(st) == golden[n]


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_stream_uses_key_stream_zero_for_every_family(family):
    """Level 1 is integer MULTILINEAR on stream 0's keys, whatever the
    Hasher's family and K; the port agrees with the reference and with
    `stream_digest_host`, also for a Hasher bound to the reference's planes."""
    th, jh = _pair(family=family, K=3, seed=0x5EB)
    bounds = [0, 3, 40, 160]
    want = jh.digest_int(_absorb(jh, TOKS, bounds))
    assert th.digest_int(_absorb(th, TOKS, bounds)) == want
    assert t_digest_host(th, TOKS[:160], 16, 64) == want
    tp = THasher.from_numpy_planes(np.asarray(jh.key_hi), np.asarray(jh.key_lo),
                                   th.spec, device="cpu")
    assert tp.digest_int(_absorb(tp, TOKS, bounds)) == want
    assert t_digest_host(tp, TOKS[:160], 16, 64) == want


def test_stream_length_sensitivity():
    """Trailing zeros and empty tails digest differently."""
    th, _ = _pair(seed=0x5EC, max_len=8)
    base = np.asarray([1, 2, 3], np.uint32)
    d = {th.digest_int(th.update(th.stream(chunk_words=8, max_chunks=8), t))
         for t in (base, np.append(base, 0), np.append(base, [0] * 5))}
    assert len(d) == 3


@pytest.mark.parametrize("data,chunk_words", [
    (b"", 1 << 16), (b"abc", 1 << 16), (bytes(range(256)) * 16, 16),
    (bytes(range(251)) * 7, 100), (b"x" * 4093, 1024)],
    ids=["empty", "abc", "two-level", "two-level-ragged", "one-level"])
def test_fingerprint_bytes_matches_reference(data, chunk_words):
    got = t_fingerprint_bytes(data, chunk_words=chunk_words, seed=0x1234)
    assert got == j_fingerprint_bytes(data, chunk_words=chunk_words, seed=0x1234)
    assert t_fingerprint_bytes(data, chunk_words=chunk_words) == \
        j_fingerprint_bytes(data, chunk_words=chunk_words)


def test_fingerprint_bytes_goldens_and_tree_route():
    assert t_fingerprint_bytes(b"") == 0x425B0BAD5E070A56
    assert t_fingerprint_bytes(b"abc") == 0xEB9E77C9EC64DBB2
    from repro_torch.hash.tree import TreeHasher

    th = TreeHasher(device="cpu")
    assert t_fingerprint_bytes(b"abc", tree=th) == th.fingerprint_bytes(b"abc")


def _raises_like(fn_t, fn_j):
    """Both calls raise, with the same exception type and message."""
    with pytest.raises(Exception) as jt:
        fn_j()
    with pytest.raises(jt.type, match="^" + re.escape(str(jt.value))):
        fn_t()


def test_overflow_and_chunk_words_errors_match_reference():
    th, jh = _pair(seed=0x0F1, max_len=8)
    toks = np.arange(13, dtype=np.uint32)
    _raises_like(lambda: th.update(th.stream(4, 2), toks),
                 lambda: jh.update(jh.stream(4, 2), toks))
    _raises_like(lambda: th.stream(0, 2), lambda: jh.stream(0, 2))
    _raises_like(lambda: th.stream(64, 2), lambda: jh.stream(64, 2))
    _raises_like(lambda: t_digest_host(th, toks, 4, max_chunks=3),
                 lambda: j_digest_host(jh, toks, 4, max_chunks=3))
    _raises_like(lambda: t_digest_host(th, toks, 0),
                 lambda: j_digest_host(jh, toks, 0))
    _raises_like(lambda: t_fingerprint_bytes(b"abc", chunk_words=0),
                 lambda: j_fingerprint_bytes(b"abc", chunk_words=0))
    # exactly max_chunks fits: 8 tokens = 2 chunks of 4
    assert th.digest_int(th.update(th.stream(4, 2), toks[:8])) == \
        jh.digest_int(jh.update(jh.stream(4, 2), toks[:8]))
    assert t_level2_seed(0x0F1) == j_level2_seed(0x0F1)


def test_update_takes_tensors_and_leaves_the_state_unchanged():
    th, _ = _pair()
    st0 = th.stream(chunk_words=16, max_chunks=64)
    st1 = th.update(st0, torch.from_numpy(TOKS[:40].view(np.int32)))
    assert (st0.fill, st0.count, int(st0.acc)) == (0, 0, 0)
    assert not st0.buf.any()
    assert th.update(st1, TOKS[:0]) is st1
    assert th.digest_int(st1) == t_digest_host(th, TOKS[:40], 16, 64)
