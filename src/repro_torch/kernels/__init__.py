"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

multihash.py     -- fused K-hash kernel, integer families (csrc/multihash.cu)
gf_multihash.py  -- fused K-hash kernel, GF(2^32) families (csrc/gf_multihash.cu)
ref.py           -- plain PyTorch versions (the CPU path and the card's oracle)
ops.py           -- family dispatch + engine launch count
autotune.py      -- fixed launch configuration, pow2 bucketing
_build.py        -- nvcc build into build/repro_torch_kernels/ + ctypes loader
"""
from . import autotune, gf_multihash, multihash, ops, ref  # noqa: F401
from .ops import launch_count  # noqa: F401
