"""repro_torch.core -- the paper's contribution on int64 tensors: strongly
universal string hashing (Lemire & Kaser 2012), with its keys, host twins,
baselines, universality checks and the deprecated free-function shims.

The exports are the reference's (`repro.core`); `device` and `pytree` are
the port's own helpers.
"""
from . import (baselines, device, gf, hostref, keys, limbs, multilinear,  # noqa: F401
               ops, pytree, theory, universality)
from .keys import KeyBuffer  # noqa: F401
from .multilinear import multilinear as multilinear_hash  # noqa: F401
from .multilinear import multilinear_2x2, multilinear_hm  # noqa: F401
from .ops import (  # noqa: F401
    FAMILIES,
    fingerprint_bytes,
    global_keys,
    hash_tokens_device,
    hash_tokens_host,
    shard_assignment,
)
