"""Port single-hash path == reference: `multilinear_hash`, `gf_hash`,
`hash_tokens_batched`, the raw accumulators, `core.multilinear` and the
numpy twins, for every named family (exact equality).

The reference runs as its own tests run it on the CPU: `backend="jnp"` for
the shape sweep (tests/test_kernels.py's SHAPES), and its Pallas kernels in
interpret mode (`backend="interpret"`, `hash_blocks(interpret=True)`) for
the odd-N HM rule and the raw accumulators.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng, t32, u32
from repro.core import hostref as jhostref
from repro.core import keys as jkeys
from repro.core import multilinear as jml
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gf_multilinear import gf_hash_blocks as j_gf_hash_blocks
from repro.kernels.multilinear import hash_blocks as j_hash_blocks
from repro_torch.core import hostref as thostref
from repro_torch.core import multilinear as tml
from repro_torch.kernels import gf_multilinear as tgfk
from repro_torch.kernels import multilinear as tmlk
from repro_torch.kernels import ops as tops

INT_FAMILIES = ["multilinear", "multilinear_2x2", "multilinear_hm"]
GF_FAMILIES = ["gf_multilinear", "gf_multilinear_hm"]
SHAPES = [(1, 2), (3, 10), (8, 128), (5, 1000), (16, 1024), (2, 4096)]
KB = jkeys.KeyBuffer(seed=0xFEED)
G = rng(0x51E)


def _port(family, toks, **kw):
    """The port's entry point for `family` on the CPU, keys from KB."""
    n = np.shape(toks)[-1]
    hi, lo = KB.hi_lo(n + 1)
    if family.startswith("gf_"):
        return tops.gf_hash(toks, lo, family=family, device="cpu", **kw)
    return tops.multilinear_hash(toks, hi, lo, family=family, device="cpu", **kw)


def _ref(family, toks, backend):
    n = np.shape(toks)[-1]
    hi, lo = (jnp.asarray(x) for x in KB.hi_lo(n + 1))
    if family.startswith("gf_"):
        return np.asarray(jops.gf_hash(toks, lo, family=family, backend=backend))
    return np.asarray(jops.multilinear_hash(toks, hi, lo, family=family,
                                            backend=backend))


def _eq(t: torch.Tensor, j):
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("family", INT_FAMILIES + GF_FAMILIES)
@pytest.mark.parametrize("B,N", SHAPES)
def test_single_hash_matches_reference(family, B, N):
    toks = u32(G, (B, N))
    got = _port(family, toks)
    _eq(got, _ref(family, toks, "jnp"))
    if family in ("multilinear", "multilinear_2x2"):
        _eq(got, thostref.multilinear_np(toks, KB.u64(N + 1)))
    elif family == "multilinear_hm":
        _eq(got, thostref.multilinear_hm_np(toks, KB.u64(N + 1)))


@pytest.mark.parametrize("family", ["multilinear_hm", "gf_multilinear_hm"])
@pytest.mark.parametrize("N", [1, 7, 33])
def test_odd_n_hm_matches_interpret_kernel(family, N):
    """At odd N the reference's kernel path pads a zero token and a zero
    key, so the last token pairs with zeros and is ignored; the port
    hashes floor(N / 2) pairs the same way."""
    toks = u32(G, (3, N))
    got = _port(family, toks)
    _eq(got, _ref(family, toks, "interpret"))
    toks[:, -1] ^= np.uint32(0xDEADBEEF)
    _eq(_port(family, toks), got)


@pytest.mark.parametrize("family", INT_FAMILIES + GF_FAMILIES)
def test_int32_tokens_and_one_row(family):
    """int32 ids are reinterpreted as u32 (not sign-extended); a 1-D row
    gives a 0-d result."""
    raw = u32(G, (4, 256))
    want = _ref(family, raw, "jnp")
    _eq(_port(family, raw.view(np.int32)), want)
    _eq(_port(family, t32(raw)), want)
    one = _port(family, raw[2])
    assert one.dim() == 0
    assert int(one) == int(np.asarray(_ref(family, raw[2], "jnp")))


@pytest.mark.parametrize("family", INT_FAMILIES + GF_FAMILIES)
def test_hash_tokens_batched_matches_reference(family):
    toks = u32(G, (3, 7))  # odd N: HM follows the reference's kernel path
    got = tops.hash_tokens_batched(toks, family=family, seed=0x77, device="cpu")
    want = jops.hash_tokens_batched(toks, family=family, seed=0x77)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_unknown_family_raises():
    toks = u32(G, (2, 4))
    hi, lo = KB.hi_lo(5)
    with pytest.raises(ValueError, match="unknown family"):
        tops.multilinear_hash(toks, hi, lo, family="gf_multilinear", device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        tops.gf_hash(toks, lo, family="multilinear", device="cpu")
    with pytest.raises(ValueError, match="key plane"):
        tops.gf_hash(toks, KB.hi_lo(4)[1], device="cpu")


@pytest.mark.parametrize("family", INT_FAMILIES + GF_FAMILIES)
def test_raw_accumulators_match_pallas_kernels(family):
    """The plain versions of kernels 3-4 (the CPU path of `hash_blocks` /
    `gf_hash_blocks`) == the reference's kernels in interpret mode and its
    jnp accumulators."""
    B, N = 8, 256
    toks = u32(G, (B, N))
    ku = KB.u64(N + 1)[1:]
    hi, lo = jkeys.split_hi_lo(ku)
    t = jnp.asarray(toks)
    if family.startswith("gf_"):
        got = tgfk.gf_hash_blocks(t32(toks), t32(lo), family=family)
        want = j_gf_hash_blocks(t, jnp.asarray(lo), family=family, block_b=8,
                                block_n=128, interpret=True)
        oracle = jref.gf_accumulate_ref(t, jnp.asarray(lo), family=family)
    else:
        got = tmlk.hash_blocks(t32(toks), torch.from_numpy(ku.view(np.int64)),
                               family=family)
        want = j_hash_blocks(t, jnp.asarray(hi), jnp.asarray(lo), family=family,
                             block_b=8, block_n=128, interpret=True)
        oracle = jref.multilinear_accumulate_ref(t, jnp.asarray(hi),
                                                 jnp.asarray(lo), family=family)
    assert tuple(got.shape) == (B, 2)
    _eq(got, want)
    _eq(got, oracle)


@pytest.mark.parametrize("fn,kdt", [(tmlk.hash_blocks, torch.int64),
                                    (tgfk.gf_hash_blocks, torch.int32)])
def test_raw_accumulator_operands_are_checked(fn, kdt):
    toks = t32(u32(G, (2, 6)))
    with pytest.raises(TypeError, match="keys"):
        fn(toks, torch.zeros(5, dtype=kdt))
    with pytest.raises(TypeError, match="keys"):
        fn(toks, torch.zeros(6, dtype=torch.int16))
    with pytest.raises(ValueError, match="unknown family"):
        fn(toks, torch.zeros(6, dtype=kdt), family="tree_multilinear")
    assert tuple(fn(toks[:0], torch.zeros(6, dtype=kdt)).shape) == (0, 2)


@pytest.mark.parametrize("family", INT_FAMILIES)
@pytest.mark.parametrize("N", [2, 64])
def test_core_multilinear_matches_reference(family, N):
    toks = u32(G, (2, 3, N))
    hi, lo = KB.hi_lo(N + 1)
    want = jml.FAMILIES[family](jnp.asarray(toks), jnp.asarray(hi), jnp.asarray(lo))
    _eq(tml.FAMILIES[family](toks, hi, lo, device="cpu"), want)
    _eq(tml.FAMILIES[family](t32(toks[0]), torch.from_numpy(hi),
                             torch.from_numpy(lo)), want[0])
    if family != "multilinear":
        with pytest.raises(ValueError, match="even length"):
            tml.FAMILIES[family](toks[..., 1:], hi, lo, device="cpu")


@pytest.mark.parametrize("nlimbs", [2, 3, 4])
def test_multilinear_multiword_matches_reference(nlimbs):
    tw = u32(G, (5, 17, nlimbs - 1))
    kl = u32(G, (18, nlimbs))
    kl[3] = 0xFFFFFFFF  # carries through every limb
    tw[:, 3] = 0xFFFFFFFF
    want = jml.multilinear_multiword(jnp.asarray(tw), jnp.asarray(kl))
    _eq(tml.multilinear_multiword(tw, kl, device="cpu"), want)
    if nlimbs == 2:  # K = 64 is plain MULTILINEAR
        _eq(tml.multilinear_multiword(tw, kl, device="cpu"),
            tml.multilinear(tw[..., 0], kl[:, 1], kl[:, 0], device="cpu"))


def test_prepare_variable_length_matches_reference():
    for L in (9, 10):
        toks = u32(G, (4, L))
        length = np.array([0, 3, L - 1, L])
        want = jml.prepare_variable_length(jnp.asarray(toks), jnp.asarray(length), L)
        got = tml.prepare_variable_length(toks, length, L, device="cpu")
        assert got.shape[-1] % 2 == 0
        _eq(got, want)


def test_host_twins_match_reference():
    toks = u32(G, (3, 12))
    ku = KB.u64(13)
    for name in ("multilinear_np", "multilinear_hm_np", "multilinear_np_u64"):
        np.testing.assert_array_equal(getattr(thostref, name)(toks, ku),
                                      getattr(jhostref, name)(toks, ku))
    for hm in (False, True):
        assert (thostref.python_int_oracle(toks[1], ku, hm)
                == jhostref.python_int_oracle(toks[1], ku, hm))
    assert int(thostref.multilinear_np(toks[1], ku)) == \
        thostref.python_int_oracle(toks[1], ku)
    with pytest.raises(ValueError, match="even"):
        thostref.multilinear_hm_np(toks[:, 1:], ku)


def test_default_device_is_cuda():
    """A numpy input runs on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    toks = u32(G, (2, 4))
    hi, lo = KB.hi_lo(5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.multilinear_hash(toks, hi, lo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.hash_tokens_batched(toks)
