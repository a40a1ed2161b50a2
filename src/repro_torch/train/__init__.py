"""Training substrate of the port: optimizers, train step, trainer loop."""
from . import optimizer, step, train_state, trainer  # noqa: F401
from .optimizer import Schedule, adafactor, adamw, make_optimizer  # noqa: F401
from .step import make_train_step  # noqa: F401
from .train_state import TrainState, init_state  # noqa: F401
from .trainer import SimulatedFault, Trainer, TrainerConfig  # noqa: F401
