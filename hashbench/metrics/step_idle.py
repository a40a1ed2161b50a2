"""step_idle: share of a training cell's traced window (whole steps) in
which no operation runs on the card: `device_idle`'s reading under a name
of its own, since an entry of `BENCHMARK.json` moves one end-to-end metric
(this one `train_tokens_per_s`)."""
from hashbench.metrics.device_idle import read  # noqa: F401
