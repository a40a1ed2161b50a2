"""One reader a per-layer metric: `read(trace, ctx)` gives a number, or None
where the trace holds nothing to read."""
