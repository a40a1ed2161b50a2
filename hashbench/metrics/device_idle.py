"""device_idle: share of the traced window in which no operation runs on
the card."""


def read(trace, ctx):
    return 1 - trace.busy_s() / trace.window_s if trace.ops else None
