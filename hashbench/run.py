"""Run one cell of the benchmark and print its result as the last line.

    python hashbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card; see
`hashbench/harness.py`.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the checkout's root, not this folder, heads the module path
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    import torch

    torch.set_num_threads(2)
    from hashbench.harness import main

    sys.exit(main(t_start=T_START))
