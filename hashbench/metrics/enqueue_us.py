"""enqueue_us: mean host time of a `Hasher.probe_indices` call, from
entering it to its return, on the host clock around each call of the
window's untraced part (the profiler's own cost left out)."""


def read(trace, ctx):
    return 1e6 * ctx.enqueue_s if ctx.enqueue_s else None
