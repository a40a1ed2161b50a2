"""Port plain versions == the reference's Pallas kernels in interpret mode.

`multihash_blocks` / `gf_multihash_blocks` run their kernel bodies on the
CPU (interpret=True, odd 4x8 tiles so rows and lanes straddle blocks), as
tests/test_multihash.py and tests/test_gf_engine.py run them. Small shapes
(B=8, N=16, K=4): each case compiles its own interpret kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ENGINE_FAMILIES, engine_case, t32
from repro.core import limbs as jlimbs
from repro.kernels.gf_multihash import gf_multihash_blocks
from repro.kernels.multihash import multihash_blocks
from repro_torch.hash.hasher import planes_to_keys
from repro_torch.kernels import ops as tops


@pytest.mark.parametrize("family", ENGINE_FAMILIES)
@pytest.mark.parametrize("ragged,mod_m", [(True, None), (False, 4097)],
                         ids=["ragged", "fixed-mod"])
def test_plain_version_matches_interpret_kernel(family, ragged, mod_m):
    toks, kh, kl, lens = engine_case(0x1A7, 8, 16, 4, ragged)
    np.testing.assert_array_equal(
        tops.multihash(t32(toks), torch.from_numpy(planes_to_keys(kh, kl)),
                       torch.from_numpy(lens), family=family,
                       mod_m=mod_m).numpy(),
        _interpret_slots(family, toks, kh, kl, lens, mod_m))


def _interpret_slots(family, toks, kh, kl, lens, mod_m):
    plan = None if mod_m is None else jlimbs.ModPlan.for_modulus(mod_m)
    m1 = jnp.asarray(np.stack([kh[:, 0], kl[:, 0]], axis=1))
    t, hi, lo, ln = (jnp.asarray(x) for x in (toks, kh[:, 1:], kl[:, 1:], lens))
    kw = dict(family=family, block_b=4, block_n=8, interpret=True, mod_m=plan)
    if family.startswith("gf_"):
        out = gf_multihash_blocks(t, lo, ln, m1, **kw)
    else:
        out = multihash_blocks(t, hi, lo, ln, m1, **kw)
    return np.asarray(out).astype(np.int64)
