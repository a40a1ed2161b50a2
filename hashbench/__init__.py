"""The benchmark of the PyTorch and CUDA port's hashing path.

`run.py` runs one cell of `BENCHMARK.json`; `harness.py` is the run;
`generator.py` makes a traffic mix's pool from the seed; `roofline.py`
counts a call's bytes; `devtrace.py` reads the profiler's trace;
`metrics/<name>.py` reads one per-layer metric; `reference/` decides
`correct`; `control.py` reads the control and the planted faults at a
cell's own size (`faults.py`). Imports no JAX and nothing of the JAX
package.
"""
