"""Port plain versions == reference oracle == reference Pallas kernels.

`multihash_ref`/`gf_multihash_ref` (the CPU path of the port's kernel
wrappers) against the JAX `jnp` oracle (`repro.kernels.ref`) over every
engine family x fixed/ragged rows x the mod_m grid x K in {1, 4}
(test_torch_interpret.py holds them against the Pallas kernels).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, MOD_GRID, engine_case, t32
from repro.core import limbs as jlimbs
from repro.kernels import ref as jref
from repro_torch.hash.hasher import planes_to_keys
from repro_torch.kernels import gf_multihash as tgfmh
from repro_torch.kernels import multihash as tmh
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _jax_slots(family, toks, kh, kl, lens, mod_m):
    plan = None if mod_m is None else jlimbs.ModPlan.for_modulus(mod_m)
    m1 = jnp.asarray(np.stack([kh[:, 0], kl[:, 0]], axis=1))
    t, hi, lo, ln = (jnp.asarray(x) for x in (toks, kh[:, 1:], kl[:, 1:], lens))
    if family.startswith("gf_"):
        out = jref.gf_multihash_ref(t, lo, ln, m1, family=family, mod_m=plan)
    else:
        out = jref.multihash_ref(t, hi, lo, ln, m1, family=family, mod_m=plan)
    return np.asarray(out).astype(np.int64)


def _port_slots(family, toks, kh, kl, lens, mod_m, width=None):
    keys = torch.from_numpy(planes_to_keys(kh, kl))
    return tops.multihash(t32(toks), keys, torch.from_numpy(lens),
                          family=family, mod_m=mod_m, width=width).numpy()


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("ragged", [False, True], ids=["fixed", "ragged"])
@pytest.mark.parametrize("mod_m", MOD_GRID)
@pytest.mark.parametrize("K", [1, 4])
def test_plain_version_matches_jnp_oracle(family, ragged, mod_m, K):
    toks, kh, kl, lens = engine_case(0x5107 + K, 11, 22, K, ragged)
    np.testing.assert_array_equal(
        _port_slots(family, toks, kh, kl, lens, mod_m),
        _jax_slots(family, toks, kh, kl, lens, mod_m))


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
def test_width_past_tokens_reads_zeros(family):
    """width > N equals zero-padding the tokens (no copy needed)."""
    toks, kh, kl, lens = engine_case(0x3D, 6, 9, 3, True)
    toks_p = np.zeros((6, 12), np.uint32)
    toks_p[:, :9] = toks
    khp, klp = (np.pad(x, ((0, 0), (0, 3))) for x in (kh, kl))
    np.testing.assert_array_equal(
        _port_slots(family, toks, khp, klp, lens, None, width=10),
        _jax_slots(family, toks_p[:, :10], khp[:, :11], klp[:, :11], lens, None))


def test_engine_launch_count_is_one_per_call():
    toks, kh, kl, lens = engine_case(1, 4, 8, 2, True)
    before = tops.launch_count()
    _port_slots("multilinear", toks, kh, kl, lens, None)
    _port_slots("gf_multilinear", toks, kh, kl, lens, 7)
    assert tops.launch_count() == before + 2
    # the kernels' own counts move only on a CUDA launch
    assert tmh.launch_count() == 0 and tgfmh.launch_count() == 0


def test_wrappers_reject_bad_operands():
    toks, kh, kl, lens = engine_case(2, 4, 8, 2, True)
    keys = torch.from_numpy(planes_to_keys(kh, kl))
    t, ln = t32(toks), torch.from_numpy(lens)
    bad = [
        dict(tokens=t.to(torch.int64)), dict(keys=keys.to(torch.int32)),
        dict(lens=ln.to(torch.int64)), dict(lens=ln[:3]),
        dict(tokens=t32(toks)[:, ::2]), dict(width=7),
        dict(width=20), dict(family="multilinear_hm", width=9),
    ]
    for over in bad:
        kw = dict(tokens=t, keys=keys, lens=ln, family="multilinear_hm",
                  width=None) | over
        with pytest.raises((TypeError, ValueError)):
            tops.multihash(kw.pop("tokens"), kw.pop("keys"), kw.pop("lens"), **kw)
    with pytest.raises(ValueError):
        tmh.multihash(t, keys, ln, family="gf_multilinear")
    with pytest.raises(ValueError):
        tgfmh.gf_multihash(t, keys, ln, family="multilinear")


@pytest.mark.parametrize("wrapper", [tmh.multihash, tgfmh.gf_multihash])
def test_wrapper_on_other_device_raises_not_falls_back(wrapper):
    """Only a CPU tensor reaches the plain version; any other device must
    launch its kernel or raise."""
    toks, kh, kl, lens = engine_case(3, 4, 8, 1, False)
    meta = [x.to("meta") for x in (t32(toks),
                                   torch.from_numpy(planes_to_keys(kh, kl)),
                                   torch.from_numpy(lens))]
    with pytest.raises(ValueError, match="no .*kernel for device"):
        wrapper(*meta)


def test_xor_reduce_any_width():
    g = np.random.default_rng(5)
    for w in (0, 1, 2, 3, 7, 64, 65):
        x = g.integers(0, 2**62, (3, w))
        want = np.bitwise_xor.reduce(x, axis=1) if w else np.zeros(3, np.int64)
        np.testing.assert_array_equal(tref.xor_reduce(torch.from_numpy(x)).numpy(),
                                      want)
