"""The rest of the port's `core/` against the reference's `repro.core`: the
whole-string GF(2^32) hashes and their Python-int oracles (`core.gf`), the
baseline hashes (`core.baselines`), the universality harness
(`core.universality`), the deprecated free-function shims (`core.ops`) and
the package's re-exports. The same seeded numpy inputs go through both
packages; every comparison is exact.
"""
import warnings
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import baselines as jb
from repro.core import gf as jgf
from repro.core import multilinear as jml
from repro.core import ops as jops
from repro.core import universality as juni
from repro.core.keys import KeyBuffer as JKeyBuffer
from repro.core.keys import MultiKeyBuffer as JMultiKeyBuffer
from repro_torch.core import baselines as tb
from repro_torch.core import gf as tgf
from repro_torch.core import multilinear as tml
from repro_torch.core import ops as tops
from repro_torch.core import universality as tuni
from repro_torch.core.keys import KeyBuffer, MultiKeyBuffer

from _torch_port import rng, u32


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).astype(np.uint64)


# ---------------------------------------------------------------------------
# core.gf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 8, 33])
@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_gf_multilinear_matches_reference(n, batch):
    g = rng(0x6F00 + n)
    toks, keys = u32(g, (*batch, n)), u32(g, n + 1)
    got = tgf.gf_multilinear(toks, keys, device="cpu")
    np.testing.assert_array_equal(_np(got), _np(jgf.gf_multilinear(toks, keys)))
    flat = toks.reshape(-1, n)
    assert [tgf.gf_multilinear_ref(r, keys) for r in flat] == \
        [jgf.gf_multilinear_ref(r, keys) for r in flat] == \
        _np(got).reshape(-1).tolist()


@pytest.mark.parametrize("n", [2, 4, 16, 34])
@pytest.mark.parametrize("batch", [(), (4,)])
def test_gf_multilinear_hm_matches_reference(n, batch):
    g = rng(0x6F80 + n)
    toks, keys = u32(g, (*batch, n)), u32(g, n + 1)
    got = tgf.gf_multilinear_hm(torch.from_numpy(toks.astype(np.int64)), keys)
    np.testing.assert_array_equal(_np(got), _np(jgf.gf_multilinear_hm(toks, keys)))
    flat = toks.reshape(-1, n)
    assert [tgf.gf_multilinear_hm_ref(r, keys) for r in flat] == \
        [jgf.gf_multilinear_hm_ref(r, keys) for r in flat] == \
        _np(got).reshape(-1).tolist()
    with pytest.raises(ValueError):
        tgf.gf_multilinear_hm(toks[..., :n - 1], keys, device="cpu")


@pytest.mark.parametrize("hm", [False, True])
def test_gf_h64_ref_and_python_oracles_match_reference(hm):
    g = rng(0x6FF0 + hm)
    for n in (2, 5, 6, 10):
        toks, keys = u32(g, n), u32(g, n + 1)
        assert tgf.gf_h64_ref(toks, keys, hm=hm) == jgf.gf_h64_ref(toks, keys, hm=hm)
    for a, b in zip(u32(g, 16), u32(g, 16)):
        q = tgf.clmul_ref(int(a), int(b))
        assert q == jgf.clmul_ref(int(a), int(b))
        assert tgf.poly_mod_ref(q) == jgf.poly_mod_ref(q)
        assert int(tgf.clmul32(int(a), int(b))) == q
    assert tgf.POLY_FULL_INT == jgf.POLY_FULL_INT


# ---------------------------------------------------------------------------
# core.baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rabin_karp", "sax", "fnv1a"])
@pytest.mark.parametrize("shape", [(16,), (7, 5), (3, 2, 9)])
def test_scan_baselines_match_reference(name, shape):
    toks = u32(rng(0xBA5E + len(shape)), shape)
    got = getattr(tb, name)(toks, device="cpu")
    np.testing.assert_array_equal(_np(got), _np(getattr(jb, name)(toks)))


def test_rabin_karp_base_matches_reference():
    toks = u32(rng(0xBA50), (4, 6))
    np.testing.assert_array_equal(_np(tb.rabin_karp(toks, 131, device="cpu")),
                                  _np(jb.rabin_karp(toks, 131)))


@pytest.mark.parametrize("shape", [(8,), (6, 12), (2, 3, 4)])
def test_nh_matches_reference(shape):
    g = rng(0x4E48 + len(shape))
    toks = u32(g, shape)
    _, klo = KeyBuffer(seed=5).hi_lo(shape[-1])
    hi, lo = tb.nh(toks, klo, device="cpu")
    jhi, jlo = jb.nh(toks, klo)
    np.testing.assert_array_equal(_np(hi), _np(jhi))
    np.testing.assert_array_equal(_np(lo), _np(jlo))
    np.testing.assert_array_equal(tb.nh_u64(toks, klo, device="cpu"),
                                  jb.nh_u64(toks, klo))
    with pytest.raises(ValueError):
        tb.nh(toks[..., :-1], klo, device="cpu")


@pytest.mark.parametrize("n_pos,alphabet,seed", [(4, 16, 3), (8, 256, 7)])
def test_zobrist_matches_reference(n_pos, alphabet, seed):
    tz = tb.Zobrist(n_pos, alphabet, seed=seed, device="cpu")
    jz = jb.Zobrist(n_pos, alphabet, seed=seed)
    np.testing.assert_array_equal(_np(tz.table), _np(jz.table))
    toks = rng(seed).integers(0, alphabet, size=(5, n_pos)).astype(np.int32)
    np.testing.assert_array_equal(_np(tz(toks)), _np(jz(toks)))
    np.testing.assert_array_equal(_np(tz(toks[0])), _np(jz(toks[0])))


# ---------------------------------------------------------------------------
# core.universality
# ---------------------------------------------------------------------------

SMALL = [("multilinear_small", (3, 1), (3, 0), 3),
         ("multilinear_hm_small", (0, 0), (2, 6), 3),
         ("folklore_xor_small", (0, 0), (2, 6), 2)]


@pytest.mark.parametrize("family,s,s2,n_keys", SMALL)
def test_universality_checks_match_reference(family, s, s2, n_keys):
    tf, jf = getattr(tuni, family), getattr(juni, family)
    for check in ("check_strong_universality", "collision_probability"):
        got = getattr(tuni, check)(tf, s, s2, K=6, L=3, n_keys=n_keys)
        want = getattr(juni, check)(jf, s, s2, K=6, L=3, n_keys=n_keys)
        assert isinstance(got, Fraction) and got == want, check
    assert tuni.check_uniformity(tf, s, K=6, L=3, n_keys=n_keys) == \
        juni.check_uniformity(jf, s, K=6, L=3, n_keys=n_keys)
    th, tn = tuni.joint_distribution(tf, s, s2, 6, 3, n_keys)
    jh, jn = juni.joint_distribution(jf, s, s2, 6, 3, n_keys)
    np.testing.assert_array_equal(th, jh)
    assert tn == jn


def test_folklore_counterexample_is_the_papers():
    p = tuni.collision_probability(tuni.folklore_xor_small, (0, 0), (2, 6),
                                   K=6, L=3, n_keys=2)
    assert p == Fraction(576, 4096)


def test_monte_carlo_collision_matches_reference():
    s = u32(rng(17), 6)
    s2 = s.copy()
    s2[3] ^= np.uint32(1)

    def port(t, hi, lo):
        return tml.multilinear(t, hi, lo, device="cpu")

    def ref(t, hi, lo):
        return jml.multilinear(jnp.asarray(t), jnp.asarray(hi), jnp.asarray(lo))

    for a, b in ((s, s2), (s, s)):
        assert tuni.monte_carlo_collision(port, a, b, 40, seed=3) == \
            juni.monte_carlo_collision(ref, a, b, 40, seed=3)


# ---------------------------------------------------------------------------
# core.ops: the deprecated shims
# ---------------------------------------------------------------------------

TOKS = np.arange(1, 13, dtype=np.uint32).reshape(2, 6)


def _one_warning(fn, package="repro_torch"):
    """Run fn capturing warnings; assert exactly one DeprecationWarning
    naming `package`.hash, attributed to this file (stacklevel)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)
           and f"{package}.hash" in str(w.message)]
    assert len(dep) == 1, [str(w.message) for w in rec]
    if package == "repro_torch":
        assert dep[0].filename == __file__
    return out


@pytest.mark.parametrize("kw", [{}, {"family": "multilinear", "variable_length": False},
                                {"family": "multilinear_2x2"}, {"keys": "0x99"}])
def test_hash_tokens_host_shim(kw):
    tkw, jkw = dict(kw), dict(kw)
    if "keys" in kw:
        tkw["keys"], jkw["keys"] = KeyBuffer(seed=0x99), JKeyBuffer(seed=0x99)
    got = _one_warning(lambda: tops.hash_tokens_host(TOKS, device="cpu", **tkw))
    want = _one_warning(lambda: jops.hash_tokens_host(TOKS, **jkw), "repro")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    one = _one_warning(lambda: tops.hash_tokens_host(TOKS[0], device="cpu", **tkw))
    assert one.shape == () and int(one) == int(want[0])
    with pytest.raises(KeyError), pytest.warns(DeprecationWarning):
        tops.hash_tokens_host(TOKS, family="gf_multilinear", device="cpu")


@pytest.mark.parametrize("family", ["multilinear", "multilinear_hm"])
def test_hash_tokens_device_shim(family):
    want = np.asarray(_one_warning(lambda: jops.hash_tokens_device(
        jnp.asarray(TOKS), family=family), "repro"))
    got = _one_warning(lambda: tops.hash_tokens_device(
        torch.from_numpy(TOKS.view(np.int32)), family=family))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), want)
    got = _one_warning(lambda: tops.hash_tokens_device(
        TOKS, family=family, device="cpu"))
    np.testing.assert_array_equal(_np(got), want)
    with pytest.raises(TypeError):  # no `use_kernel`: a card tensor runs the kernel
        tops.hash_tokens_device(TOKS, family, None, True, device="cpu")


@pytest.mark.parametrize("case", ["seed", "keys", "ragged"])
def test_hash_tokens_device_multi_shim(case):
    if case == "seed":
        got = _one_warning(lambda: tops.hash_tokens_device_multi(
            TOKS, n_hashes=2, seed=7, backend="host", device="cpu"))
        want = _one_warning(lambda: jops.hash_tokens_device_multi(
            TOKS, n_hashes=2, seed=7, backend="host"), "repro")
    elif case == "keys":
        mkb, jmkb = (MultiKeyBuffer(seed=0xCE, n_hashes=3),
                     JMultiKeyBuffer(seed=0xCE, n_hashes=3))
        got = _one_warning(lambda: tops.hash_tokens_device_multi(
            TOKS, keys=mkb, family="multilinear_hm", out_bits=64, device="cpu"))
        want = _one_warning(lambda: jops.hash_tokens_device_multi(
            TOKS, keys=jmkb, family="multilinear_hm", out_bits=64,
            backend="jnp"), "repro")
        with pytest.raises(ValueError), pytest.warns(DeprecationWarning):
            tops.hash_tokens_device_multi(TOKS, n_hashes=2, keys=mkb,
                                          device="cpu")
    else:
        items = [TOKS[0, :3], TOKS[1], TOKS[0, :0]]
        got = _one_warning(lambda: tops.hash_tokens_device_multi(
            items, n_hashes=3, device="cpu"))
        want = _one_warning(lambda: jops.hash_tokens_device_multi(
            items, n_hashes=3, backend="jnp"), "repro")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError), pytest.warns(DeprecationWarning):
        tops.hash_tokens_device_multi(TOKS, family="sha256", device="cpu")


def test_fingerprint_bytes_shim():
    for data, kw in ((b"strongly universal", {}),
                     (bytes(range(256)) * 64, {"chunk_words": 1 << 10})):
        got = _one_warning(lambda: tops.fingerprint_bytes(data, **kw))
        assert got == _one_warning(lambda: jops.fingerprint_bytes(data, **kw),
                                   "repro")
    got = _one_warning(lambda: tops.fingerprint_bytes(
        b"xyz", keys=KeyBuffer(seed=0xAA)))
    assert got == _one_warning(lambda: jops.fingerprint_bytes(
        b"xyz", keys=JKeyBuffer(seed=0xAA)), "repro")


@pytest.mark.parametrize("salt,n_shards", [(0, 8), (3, 13)])
def test_shard_assignment_shim(salt, n_shards):
    rows = (np.arange(40, dtype=np.uint32) % 7).reshape(10, 4)
    got = _one_warning(lambda: tops.shard_assignment(rows, n_shards, salt=salt,
                                                     device="cpu"))
    want = _one_warning(lambda: jops.shard_assignment(rows, n_shards,
                                                      salt=salt), "repro")
    np.testing.assert_array_equal(got, want)


def test_global_keys_and_family_table_shims():
    kb = _one_warning(tops.global_keys)
    np.testing.assert_array_equal(kb.u64(4), JKeyBuffer(seed=0x1E53).u64(4))
    assert tops.FAMILIES.keys() == jops.FAMILIES.keys()
    hi, lo = KeyBuffer(seed=0x1E53).hi_lo(TOKS.shape[1] + 1)
    for name, fam in tops.FAMILIES.items():
        jfam = jops.FAMILIES[name]
        assert (fam.strongly_universal, fam.needs_even) == \
            (jfam.strongly_universal, jfam.needs_even)
        np.testing.assert_array_equal(
            _np(fam.device_fn(TOKS, hi, lo, device="cpu")),
            _np(jfam.device_fn(jnp.asarray(TOKS), jnp.asarray(hi), jnp.asarray(lo))))
    odd = TOKS[:, :5]
    np.testing.assert_array_equal(tops.pad_even(odd), jops.pad_even(odd))
    assert tops.pad_even(TOKS) is TOKS


def test_no_port_module_imports_the_shims():
    """Nothing inside the package may call the deprecated shims: no module
    but `core/__init__.py` imports `core.ops`."""
    import re
    from pathlib import Path

    root = Path(tml.__file__).resolve().parents[1]
    outside = re.compile(r"core\.ops|core import[^\n]*\bops\b")
    inside = re.compile(r"from \.ops\b|from \. import[^\n]*\bops\b")
    for path in root.rglob("*.py"):
        rel = path.relative_to(root).as_posix()
        if rel in ("core/ops.py", "core/__init__.py"):
            continue
        text = path.read_text()
        bad = (inside if rel.startswith("core/") else outside).search(text)
        assert bad is None, (rel, bad.group(0))


# ---------------------------------------------------------------------------
# re-exports
# ---------------------------------------------------------------------------

# The port's own helper modules, with no counterpart in `repro.core`.
PORT_ONLY = {"device", "pytree"}


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and n not in ("annotations",)}


def test_core_exports_match_reference():
    assert _public(J) - _public(T) == set(), sorted(_public(J) - _public(T))
    assert _public(T) - _public(J) == PORT_ONLY, sorted(_public(T) - _public(J))
    assert T.multilinear_hash is tml.multilinear
    assert T.KeyBuffer is KeyBuffer
    assert T.fingerprint_bytes is tops.fingerprint_bytes
