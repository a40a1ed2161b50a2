"""The carry-less single-hash kernel's product forms and its finish mode ==
the reference, on the CPU (exact equality).

`kernels.ref.gf_matrix_accumulate_ref` (the GF(2) matrix form that the
kernel's plain family runs on the b1 tensor cores) and `kernels.ref.bmul32`
(the integer-multiply product of its HM family) are held against the
bit-serial products and the reference's interpret-mode Pallas kernel;
`kernels.ref.gf_hash_ref` and the port's `gf_hash` (the finish mode: m1 and
Barrett in the kernel's write) against the reference's `gf_hash` and its
pure-Python integer oracles. Inputs come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng, t32, u32
from repro.core import gf as jgf
from repro.kernels import ops as jops
from repro.kernels.gf_multilinear import gf_hash_blocks as j_gf_hash_blocks
from repro_torch.core import gf as tgf
from repro_torch.kernels import autotune, ref
from repro_torch.kernels import gf_multilinear as tgfk
from repro_torch.kernels import ops as tops

GF_FAMILIES = ["gf_multilinear", "gf_multilinear_hm"]
G = rng(0x6F51)
ADVERSARIAL = [0xFFFFFFFF, 0x88888888, 0x11111111, 0x80000000, 0x00000001,
               0x00010000, 0]


def _keys(N):
    return u32(G, N + 1)  # key 0 is m1


def _interpret_blocks(toks, keys32, family):
    """The reference's Pallas kernel in interpret mode, on zero-padded
    blocks (as its own wrapper pads them) -> (B, 2) int64 (hi, lo)."""
    B, N = toks.shape
    Bp, Np = -(-B // 8) * 8, -(-N // 512) * 512
    tp = np.zeros((Bp, Np), np.uint32)
    tp[:B, :N] = toks
    kp = np.zeros(Np, np.uint32)
    kp[:N] = keys32
    out = j_gf_hash_blocks(jnp.asarray(tp), jnp.asarray(kp), family=family,
                           block_b=8, block_n=512, interpret=True)
    return np.asarray(out)[:B].astype(np.int64)


@pytest.mark.parametrize("B", [1, 17])
@pytest.mark.parametrize("N", [1, 2, 7, 8, 300, 2049])
def test_matrix_form_matches_bit_serial_and_pallas(B, N):
    """(a) The plain family as the kernel computes it -- the parity of
    AND-popcounts of token bits against Toeplitz key words -- == the
    bit-serial accumulator == the reference's interpret-mode kernel, with
    tokens whose sign bit is set."""
    toks = u32(G, (B, N))
    toks[:, 0] |= np.uint32(0x80000000)
    keys = u32(G, N)
    got = ref.gf_matrix_accumulate_ref(t32(toks), t32(keys))
    assert torch.equal(got, ref.gf_accumulate_ref(t32(toks), t32(keys)))
    np.testing.assert_array_equal(got.numpy(),
                                  _interpret_blocks(toks, keys, "gf_multilinear"))


def test_toeplitz_word_is_the_key_column():
    """Bit v of the B word for output bit j is k[j - v] (0 off the key)."""
    k = torch.from_numpy(u32(G, 64).astype(np.int64))
    for j in range(64):
        w = ref.toeplitz_word(k, j)
        want = torch.zeros_like(k)
        for v in range(32):
            if 0 <= j - v < 32:
                want |= ((k >> (j - v)) & 1) << v
        assert torch.equal(w, want), j


@pytest.mark.parametrize("a", ["random"] + ADVERSARIAL)
def test_bmul_matches_clmul(a):
    """(b) The integer-multiply product with holes == the bit-serial
    carry-less product: 10^5 seeded pairs, and operands where 8 terms meet
    in one bit position (all ones, one bit class, single bits, 0)."""
    if a == "random":
        x = torch.from_numpy(u32(G, 100_000).astype(np.int64))
        y = torch.from_numpy(u32(G, 100_000).astype(np.int64))
    else:
        y = torch.tensor(ADVERSARIAL + [1 << i for i in range(32)]
                         + list(u32(G, 64)), dtype=torch.int64)
        x = torch.full_like(y, a)
    got = ref.bmul32(x, y)
    assert torch.equal(got, tgf.clmul32(x, y))
    assert torch.equal(got, ref.bmul32(y, x))
    if a != "random":
        hi, lo = jgf.clmul32(np.asarray(x, np.uint32), np.asarray(y, np.uint32))
        want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), want)


def _cases():
    for family in GF_FAMILIES:
        for N in (1, 7, 64, 301):
            for backend in ("interpret", "jnp"):
                # the reference's jnp HM path raises at odd N (ROADMAP Queue 3)
                if not (backend == "jnp" and family.endswith("_hm") and N % 2):
                    yield family, N, backend


@pytest.mark.parametrize("family,N,backend", list(_cases()))
def test_finish_matches_reference_gf_hash(family, N, backend):
    """(c) The finish mode's plain version and the port's `gf_hash` on the
    CPU == the reference's `gf_hash`, both families, odd N."""
    toks = u32(G, (5, N))
    keys = _keys(N)
    want = np.asarray(jops.gf_hash(toks, jnp.asarray(keys), family=family,
                                   backend=backend)).astype(np.int64)
    k = t32(keys)
    np.testing.assert_array_equal(
        ref.gf_hash_ref(t32(toks), k[1:], k[0], family=family).numpy(), want)
    np.testing.assert_array_equal(
        tgfk.gf_hash_rows(t32(toks), k, family=family).numpy(), want)
    np.testing.assert_array_equal(
        tops.gf_hash(toks, keys, family=family, device="cpu").numpy(), want)


@pytest.mark.parametrize("family", GF_FAMILIES)
def test_finish_one_row(family):
    """(c) A 1-D row gives a 0-d hash equal to the reference's."""
    toks = u32(G, 33)
    keys = _keys(33)
    got = tops.gf_hash(toks, keys, family=family, device="cpu")
    assert got.dim() == 0
    assert int(got) == int(jops.gf_hash(toks, jnp.asarray(keys), family=family,
                                        backend="interpret"))


@pytest.mark.parametrize("family", GF_FAMILIES)
@pytest.mark.parametrize("N", [2, 10, 64])
def test_finish_matches_integer_oracles(family, N):
    """(d) The port's `gf_hash` == the reference's pure-Python oracles
    `gf_multilinear_ref` / `gf_multilinear_hm_ref` on a few rows."""
    toks = u32(G, (3, N))
    keys = _keys(N)
    got = tops.gf_hash(toks, keys, family=family, device="cpu").numpy()
    oracle = (jgf.gf_multilinear_ref if family == "gf_multilinear"
              else jgf.gf_multilinear_hm_ref)
    assert [int(x) for x in got] == [oracle(row, keys) for row in toks]


def test_finish_operands_are_checked():
    toks = t32(u32(G, (2, 6)))
    with pytest.raises(TypeError, match="keys"):
        tgfk.gf_hash_rows(toks, torch.zeros(6, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown family"):
        tgfk.gf_hash_rows(toks, torch.zeros(7, dtype=torch.int32),
                          family="multilinear")
    assert tuple(tgfk.gf_hash_rows(toks[:0], torch.zeros(7, dtype=torch.int32)
                                   ).shape) == (0,)


@pytest.mark.parametrize("B,cols", [(65536, 1024), (64, 1 << 20),
                                    (64, (1 << 20) - 2), (1, 1), (17, 2049),
                                    (300, 4097), (4, 1 << 28)])
def test_split_covers_the_columns(B, cols):
    """The launch's column split: a multiple of the kernel's 32-column step,
    at most 2^26 columns (the b1 counts stay exact), covering the row; one
    split when the row blocks fill 132 SMs, many for a few long rows."""
    for pairwise, key in ((False, "min_blocks"), (True, "hm_min_blocks")):
        split = autotune.gf_single_split(B, cols, 132, pairwise)
        splits = max(1, -(-cols // split))
        assert split % autotune.GF_SINGLE_STEP == 0
        assert split <= autotune.GF_SINGLE_MAX_SPLIT
        assert splits * split >= cols and (splits - 1) * split < max(cols, 1)
        blocks = -(-B // autotune.gf_single_rows())
        if blocks >= 132 * autotune.GF_SINGLE[key]:
            assert splits == 1
        if B == 64 and cols >= 1 << 20:
            assert splits > 100
