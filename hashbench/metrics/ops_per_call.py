"""ops_per_call: device operations (kernels, copies, sets) a call puts on
the card in the traced window."""


def read(trace, ctx):
    return len(trace.ops) / trace.calls if trace.ops and trace.calls else None
