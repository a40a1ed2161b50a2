"""repro_torch -- the PyTorch/CUDA port of `repro`: the hashing engine and,
on top of it, the models, their serving engine and their trainer.

Imports `torch` and numpy only, never `jax` or `repro` (the JAX package is
the reference the port is held against). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the fused K-hash engine is two
hand-written CUDA kernels (`kernels/csrc/`) built with nvcc on first use.
"""
from . import (checkpoint, configs, core, data, hash, kernels, models,  # noqa: F401
               parallel, quality, serve, train)
from .data import BloomFilter, ExactDedup, HashPipeline, PipelineConfig  # noqa: F401
from .hash import Hasher, HashSpec  # noqa: F401
from .train import (Schedule, SimulatedFault, Trainer, TrainerConfig,  # noqa: F401
                    TrainState, adafactor, adamw, init_state, make_optimizer,
                    make_train_step)
