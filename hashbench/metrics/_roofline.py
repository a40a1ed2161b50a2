"""A kernel's share of its bytes roofline: the least time of the traced
calls by the bytes their inputs need (`hashbench/roofline.py`) over the
device time of the kernel's operations, told by a tag in their names."""
from hashbench import roofline


def share(trace, ctx, tag: str, key_bytes: int):
    ran = sum(e - s for name, s, e in trace.ops if tag in name)
    if not ran:
        return None
    nbytes = sum(roofline.probe_call_bytes(ctx.lengths[b], ctx.N, ctx.K, key_bytes)
                 for b in trace.batches)
    least = roofline.least_seconds(nbytes, trace.kind)
    return None if least is None else 100 * least / ran
