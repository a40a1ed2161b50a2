"""gf_multihash_roofline: kernel 2 (`csrc/gf_multihash.cu`, the carry-less
engine; `engine_tile_kernel<GfEngine, ...>`, `engine_finish<GfEngine>`)
against the bytes of its calls, 4-byte keys (the low half of each)."""
from hashbench.metrics._roofline import share


def read(trace, ctx):
    return share(trace, ctx, "GfEngine", 4)
