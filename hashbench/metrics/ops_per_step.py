"""ops_per_step: device operations (kernels, copies, sets) a train step
puts on the card in the traced window: `ops_per_call`'s reading under a
name of its own, since an entry of `BENCHMARK.json` moves one end-to-end
metric (this one `train_tokens_per_s`)."""
from hashbench.metrics.ops_per_call import read  # noqa: F401
