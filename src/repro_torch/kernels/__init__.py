"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

multihash.py      -- fused K-hash kernel, integer families (csrc/multihash.cu)
gf_multihash.py   -- fused K-hash kernel, GF(2^32) families (csrc/gf_multihash.cu)
multilinear.py    -- single-hash kernel, integer families (csrc/multilinear.cu)
gf_multilinear.py -- single-hash kernel, GF(2^32) families, raw or finished
                     (csrc/gf_multilinear.cu on csrc/gf_single.cuh)
ref.py            -- plain PyTorch versions (the CPU path and the card's oracle)
ops.py            -- engine dispatch + launch count; multilinear_hash, gf_hash,
                     hash_tokens_batched
autotune.py       -- launch configurations, the engine's column split, pow2 bucketing
_build.py         -- nvcc build into build/repro_torch_kernels/ + ctypes loader
"""
from . import autotune, gf_multihash, gf_multilinear, multihash, multilinear, ops, ref  # noqa: F401
from .ops import gf_hash, hash_tokens_batched, launch_count, multilinear_hash  # noqa: F401
