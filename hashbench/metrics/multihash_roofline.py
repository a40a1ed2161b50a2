"""multihash_roofline: kernel 1 (`csrc/multihash.cu`, the integer engine;
its kernels are instances of `engine_tile_kernel<IntEngine, ...>` and
`engine_finish<IntEngine>`) against the bytes of its calls, 8-byte keys."""
from hashbench.metrics._roofline import share


def read(trace, ctx):
    return share(trace, ctx, "IntEngine", 8)
