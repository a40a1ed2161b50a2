"""repro_torch.quality: the hash-quality battery of the port.

- `metrics`:  measurements on tensors + exact-null threshold math.
- `keygen`:   counter-based Threefry input/key streams (no global RNG),
              bit-identical to the reference's streams.
- `families`: per-row-keyed adapters for every registered family, plus the
              seeded known-bad controls the battery must flag.
- `runner`:   the report sweep and its emit/check CLI
              (`python -m repro_torch.quality.runner`).
"""
from . import families, keygen, metrics, runner
from .families import BatteryFamily, battery_families
from .keygen import QUALITY_SEED
from .runner import compare_reports, run_battery

__all__ = [
    "BatteryFamily",
    "QUALITY_SEED",
    "battery_families",
    "compare_reports",
    "families",
    "keygen",
    "metrics",
    "run_battery",
    "runner",
]
