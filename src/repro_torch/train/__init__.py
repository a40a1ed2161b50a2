"""Training substrate of the port: optimizers, train step (single-device
and sharded over a mesh), train state and its placements, trainer loop."""
from . import optimizer, step, train_state, trainer  # noqa: F401
from .optimizer import Schedule, adafactor, adamw, make_optimizer  # noqa: F401
from .step import jit_train_step, make_train_step  # noqa: F401
from .train_state import TrainState, init_state, state_shardings  # noqa: F401
from .trainer import SimulatedFault, Trainer, TrainerConfig  # noqa: F401
