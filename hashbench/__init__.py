"""The benchmark of the PyTorch and CUDA port: its hashing path and its
trainer.

`run.py` runs one cell of `BENCHMARK.json`; `harness.py` is the run;
`generator.py` makes a traffic mix's pool from the seed; `roofline.py`
counts a call's bytes; `devtrace.py` reads the profiler's trace;
`metrics/<name>.py` reads one per-layer metric; `reference/` decides
`correct`; `control.py` reads the control and the planted faults at a
cell's own size (`faults.py`). A configuration that names a runner is
run by `runners/<runner>.py`: `runners/train_step.py` trains on packed
batches (`lm_batches.py`), counts a step's FLOPs (`flops.py`) and is
judged by `reference/lm.py`, its faults in `model_faults.py`. Imports no
JAX and nothing of the JAX package.
"""
