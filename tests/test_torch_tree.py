"""Port tree fingerprints (`repro_torch.hash.tree`) == reference
(`repro.hash.tree`), exact equality: goldens, the family x leaf_words x
length grid, digest_tokens bucketing, TreeStream split invariance,
pytree roots and leaf maps, the long-input routes, and the theory bound."""
import collections
from fractions import Fraction

import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, rng, t32, u32
from repro.core import theory as jtheory
from repro.data import ExactDedup as JExact
from repro.hash import fingerprint_bytes as j_fingerprint_bytes
from repro.hash import tree as jtree
from repro_torch.core import theory as ttheory
from repro_torch.data import ExactDedup as TExact
from repro_torch.hash import fingerprint_bytes as t_fingerprint_bytes
from repro_torch.hash import tree as ttree
from repro_torch.kernels import ops as tops

TOKS123 = (np.arange(123, dtype=np.uint32) * np.uint32(2654435761)) \
    ^ np.uint32(0x9E37)
G = rng(0x7EE)


def _th(**kw):
    return ttree.TreeHasher(ttree.TreeSpec(**kw), device="cpu")


@pytest.fixture(scope="module")
def th8():
    return _th(leaf_words=8)


_JAX_HASHERS: dict = {}


def _jth(**kw):
    """Reference TreeHashers, one per spec (their jit caches are reused)."""
    spec = jtree.TreeSpec(**kw)
    if spec not in _JAX_HASHERS:
        _JAX_HASHERS[spec] = jtree.TreeHasher(spec)
    return _JAX_HASHERS[spec]


# -- goldens (the reference's pinned wire format) ------------------------------

@pytest.mark.parametrize("tokens,want", [
    (np.zeros(0, np.uint32), 0x21D2B472322CB1E9),
    (np.zeros(1, np.uint32), 0xEB510147F276AD67),
    (np.asarray([42], np.uint32), 0xC217AE8CF449D621),
    (TOKS123[:8], 0x1C97D1D79E5B347D),
    (TOKS123, 0x82F15E0BB5AF2B2B),
])
def test_golden_fingerprints(th8, tokens, want):
    assert th8.fingerprint(tokens) == want
    assert th8.fingerprint(t32(tokens)) == want
    assert th8.digest_host(tokens) == want
    hi, lo = th8.digest_tokens(t32(tokens)).tolist()
    assert (hi << 32) | lo == want


def test_golden_bytes(th8):
    assert th8.fingerprint_bytes(b"abc") == 0x613539B287997EE7
    assert th8.fingerprint_array(np.frombuffer(b"abc", np.uint8)) == 0x613539B287997EE7


# -- the parity grid --------------------------------------------------------------

def _lengths(lw):
    return [0, 1, lw - 1, lw, lw + 1, 5 * lw + 3]


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("lw", [1, 3, 8, 256])
@pytest.mark.parametrize("which", range(6))
def test_parity_grid(family, lw, which):
    """fingerprint, fingerprint_bytes, digest_tokens (int and 0-d tensor
    n_tokens over a zero-and-garbage padded bucket) and digest_host of the
    port == the reference's digest_host; the reference's jitted
    fingerprint and fingerprint_bytes too at the default leaf_words'
    longest length."""
    n = _lengths(lw)[which]
    th, jth = _th(leaf_words=lw, family=family), _jth(leaf_words=lw, family=family)
    toks = u32(rng(0x6A1D + 97 * lw + n), n)
    want = jth.digest_host(toks)
    assert th.fingerprint(toks) == want
    assert th.digest_host(toks) == want
    bucket = np.concatenate([toks, u32(G, 2 * lw + 1)])  # garbage past n
    for n_tokens in (n, torch.tensor(n)):
        hi, lo = th.digest_tokens(t32(bucket), n_tokens=n_tokens).tolist()
        assert (hi << 32) | lo == want
    data = toks.tobytes()[: max(0, 4 * n - 1)]  # odd byte length: a pad byte
    words = np.frombuffer(data + b"\0" * (-len(data) % 4), "<u4")
    want_b = jth.digest_host(words, tag=len(data))
    assert th.fingerprint_bytes(data) == want_b
    assert th.fingerprint_array(np.frombuffer(data, np.uint8).copy()) == want_b
    if which == 5 and lw == 256:
        assert jth.fingerprint(toks) == want
        assert jth.fingerprint_bytes(data) == want_b


@pytest.mark.parametrize("family", ["multilinear", "gf_multilinear_hm"])
def test_digest_tokens_matches_reference_digest_tokens(th8, family):
    th, jth = _th(leaf_words=8, family=family), _jth(leaf_words=8, family=family)
    toks = u32(G, 53)
    buf = np.zeros(64, np.uint32)
    buf[:53] = toks
    want = np.asarray(jth.digest_tokens(buf, n_tokens=53)).astype(np.int64)
    got = th.digest_tokens(t32(buf), n_tokens=torch.tensor(53, dtype=torch.int32))
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert th.digest_tokens(t32(toks)).tolist() == want.tolist()


def test_fingerprint_is_one_engine_launch(th8):
    for n in (0, 7, 123, 1000):
        before = tops.launch_count()
        th8.fingerprint(u32(G, n))
        assert tops.launch_count() == before + 1


def test_fingerprint_array_of_tensors_hashes_their_bytes(th8):
    """bf16, non-contiguous, 0-d, bool and odd byte lengths: the tensor's
    C-order bytes, as `np.asarray(x).tobytes()` gives them."""
    base = torch.from_numpy(G.standard_normal((6, 5)).astype(np.float32))
    cases = [base, base.t(), base[:, ::2], base.to(torch.bfloat16),
             base.to(torch.bfloat16).t(), base[0, 0], base > 0,
             torch.arange(7, dtype=torch.uint8), torch.arange(3, dtype=torch.int16),
             torch.zeros(0)]
    jth = _jth(leaf_words=8)
    for x in cases:
        raw = x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        assert th8.fingerprint_array(x) == th8.fingerprint_bytes(raw)
        words = np.frombuffer(raw + b"\0" * (-len(raw) % 4), "<u4")
        assert th8.fingerprint_array(x) == jth.digest_host(words, tag=len(raw))


# -- key schedule, spec, cache ---------------------------------------------------

def test_key_schedule_matches_reference(th8):
    jth = _jth(leaf_words=8)
    assert ttree.fold_seed(0x5EED) == jtree.fold_seed(0x5EED)
    assert ttree.FOLD_WORDS == jtree.FOLD_WORDS
    for level in range(8):
        np.testing.assert_array_equal(th8.level_keys_u64(level),
                                      jth.level_keys_u64(level))
    assert ttree.TreeSpec().leaf_spec() == ttree.TreeSpec().leaf_spec()
    assert (ttree.TreeSpec().leaf_words, ttree.TreeSpec().family) == (
        jtree.TreeSpec().leaf_words, jtree.TreeSpec().family)
    for bad, err in (({"leaf_words": 0}, ValueError), ({"family": "x"}, KeyError)):
        with pytest.raises(err):
            ttree.TreeSpec(**bad)
        with pytest.raises(err):
            jtree.TreeSpec(**bad)


def test_default_tree_hasher_cache_and_not_ported():
    a = ttree.default_tree_hasher(device="cpu")
    assert a is ttree.default_tree_hasher(device="cpu")
    assert ttree.default_tree_hasher(ttree.TreeSpec(leaf_words=32),
                                     device="cpu") is not a
    for lw in range(1, 20):
        ttree.default_tree_hasher(ttree.TreeSpec(leaf_words=lw), device="cpu")
    assert len(ttree._DEFAULT) <= 16
    # the mesh routes, once refused, are cached per mesh and agree
    from _torch_port import cpu_mesh

    m = ttree.default_tree_hasher(mesh=cpu_mesh(2))
    assert m is ttree.default_tree_hasher(mesh=cpu_mesh(2)) and m is not a
    assert m.sharded.n_shards == 2 and m.device.type == "cpu"
    toks = np.arange(700, dtype=np.uint32)
    assert ttree.stream_tree(mesh=cpu_mesh(2)).update(toks).digest_int() \
        == a.fingerprint(toks)
    tree = {"x": np.arange(6, dtype=np.int32)}
    assert ttree.fingerprint_pytree(tree, mesh=cpu_mesh(2)) == \
        ttree.fingerprint_pytree(tree, device="cpu")
    with pytest.raises(ValueError):
        _th(leaf_words=8)._fold_impl(torch.zeros(1, dtype=torch.int64), 1, -1)


# -- TreeStream --------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(4))
def test_stream_split_invariance_matches_reference(th8, trial):
    g = rng(0x57 + trial)
    toks = u32(g, 731)
    want = _jth(leaf_words=8).fingerprint(toks)
    leaf_batch = int(g.integers(1, 8))
    cuts = [0] + sorted(g.integers(0, len(toks) + 1, size=6).tolist()) + [len(toks)]
    s, js = th8.stream(leaf_batch=leaf_batch), _jth(leaf_words=8).stream(leaf_batch)
    for a, b in zip(cuts[:-1], cuts[1:]):
        s.update(toks[a:b] if trial % 2 else t32(toks[a:b]))
        js.update(toks[a:b])
    assert s.digest_int() == js.digest_int() == want
    assert s.total == js.total == len(toks)


def test_stream_digest_is_nondestructive(th8):
    toks = u32(G, 100)
    s = th8.stream(leaf_batch=2)
    s.update(toks[:57])
    assert s.digest_int() == th8.fingerprint(toks[:57])
    assert s.digest_int() == th8.fingerprint(toks[:57])
    s.update(toks[57:])
    assert s.digest_int() == th8.fingerprint(toks) == _jth(leaf_words=8).fingerprint(toks)
    empty = th8.stream()
    assert empty.digest_int() == th8.fingerprint(np.zeros(0, np.uint32))
    with pytest.raises(ValueError):
        th8.stream(leaf_batch=0)


def test_stream_flushes_one_launch_per_batch(th8):
    s = th8.stream(leaf_batch=4)
    before = tops.launch_count()
    s.update(u32(G, 31))            # 3 leaves: buffered
    assert tops.launch_count() == before
    s.update(u32(G, 10))            # 41 tokens, 5 leaves: one flush
    assert tops.launch_count() == before + 1 and s._nbuf == 1
    s.digest_int()                  # the final partial leaf: one more
    assert tops.launch_count() == before + 2


# -- pytrees ---------------------------------------------------------------------

def _pytree():
    g = rng(0x9E)
    return {"w": g.standard_normal((4, 6)).astype(np.float32),
            "b": {"y": np.float32(2.5), "x": np.ones(5, np.int32)},
            "od": collections.OrderedDict([("z", np.arange(3, dtype=np.int16)),
                                           ("a", np.arange(7, dtype=np.uint8))]),
            "seq": [np.zeros(2, np.float32), None, (np.int32(4), [])],
            "none": None}


def test_fingerprint_pytree_matches_reference():
    th = _th()
    tree = _pytree()
    got, want = ttree.fingerprint_pytree(tree, th), jtree.fingerprint_pytree(tree)
    assert got.leaves == want.leaves and got.root == want.root
    assert list(got.leaf_map()) == ["b/x", "b/y", "od/z", "od/a", "seq/0",
                                    "seq/2/0", "w"]
    as_tensors = {k: v for k, v in tree.items()}
    as_tensors["w"] = torch.from_numpy(tree["w"])
    assert ttree.fingerprint_pytree(as_tensors, device="cpu") == got
    assert ttree.root_of_leaf_fingerprints(list(got.leaves), th) == \
        jtree.root_of_leaf_fingerprints(list(want.leaves))


def test_pytree_root_covers_structure():
    th = _th()
    pf = ttree.fingerprint_pytree({"a": np.int32(1), "b": np.int32(2)}, th)
    sw = ttree.fingerprint_pytree({"b": np.int32(1), "a": np.int32(2)}, th)
    assert sorted(p for _, p in pf.leaves) == sorted(p for _, p in sw.leaves)
    assert pf.root != sw.root
    assert ttree.root_of_leaf_fingerprints(list(pf.leaves)[::-1], th) != pf.root


def test_flatten_map_roundtrip():
    from repro_torch.core.pytree import flatten_with_paths, map_with_paths

    Pt = collections.namedtuple("Pt", "x y")
    tree = {"n": Pt(1, [2, 3]), "d": collections.defaultdict(int, {"q": 4, "p": 5}),
            "e": {}, "f": None}
    assert flatten_with_paths(tree) == [("d/p", 5), ("d/q", 4), ("n/.x", 1),
                                        ("n/.y/0", 2), ("n/.y/1", 3)]
    out = map_with_paths(lambda p, v: (p, v), tree)
    assert out["n"] == Pt(("n/.x", 1), [("n/.y/0", 2), ("n/.y/1", 3)])
    assert isinstance(out["d"], collections.defaultdict) and out["f"] is None


# -- routes that use the tree --------------------------------------------------------

def test_fingerprint_bytes_tree_route():
    data = (TOKS123 % 256).astype(np.uint8).tobytes()[:333]
    th = _th()
    assert t_fingerprint_bytes(data, tree=th) == th.fingerprint_bytes(data) == \
        j_fingerprint_bytes(data, tree=_jth())
    assert t_fingerprint_bytes(b"abc") == 0xEB9E77C9EC64DBB2  # default layout


def test_add_documents_long_route_matches_reference():
    """Short documents batch, long ones take the tree; first wins in
    arrival order, duplicates at both lengths."""
    g = rng(0xD0C)
    short = [u32(g, int(n)) for n in g.integers(0, 40, 12)]
    long = [u32(g, int(n)) for n in (64, 64, 100, 300)]
    docs = short[:6] + [long[0], long[1], short[2], long[0]] + short[6:] + \
        [long[2], long[3], long[2], long[1]]
    t, j = TExact(device="cpu"), JExact()
    got = t.add_documents(docs, long_words=64)
    np.testing.assert_array_equal(got, j.add_documents(docs, long_words=64))
    assert t.seen == j.seen and not got[9] and not got[-2]
    again = [long[3], short[0], u32(g, 70)]
    np.testing.assert_array_equal(t.add_documents(again, long_words=64),
                                  j.add_documents(again, long_words=64))


# -- theory (pure Python copy) --------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("tree_eps_level", ()), ("tree_eps_level", (16, 32)),
    ("tree_depth", (1,)), ("tree_depth", (5,)), ("tree_depth", (1 << 20,)),
    ("tree_collision_bound", (1,)), ("tree_collision_bound", (10**9,)),
    ("stinson_random_bits", (1024, 32)), ("multilinear_random_bits", (1024, 32, 32)),
    ("multilinear_random_bits", (100, 32, 32, True)), ("stinson_ratio", (4096, 32, 32)),
    ("optimal_L_memory", (1 << 20, 32)), ("optimal_L_compute", (32, 1.6)),
    ("compute_cost_per_bit", (32.0, 32, 1.6)), ("trailing_zeros", (40,)),
    ("prop31_solution_count", (8, 4)), ("prop31_solve_brute", (6, 1, 3, 6, 3)),
    ("prop31_solve_constructive", (6, 1, 3, 6, 3)), ("exact_pairwise_prob", (64, 32)),
])
def test_theory_matches_reference(name, args):
    assert getattr(ttheory, name)(*args) == getattr(jtheory, name)(*args)


def test_tree_collision_bound_shape():
    eps = ttheory.tree_eps_level()
    assert eps == Fraction(1, 2**33)
    assert ttheory.tree_collision_bound(10**9) == (30 + 2) * eps < Fraction(1, 2**27)
    with pytest.raises(ValueError):
        ttheory.tree_depth(0)
