"""Model zoo of the port: layers, attention, MoE, the state-space layers,
the block-structured LM, the encoder-decoder and the weight carry-over from
the reference (`convert.params_from_jax`)."""
from . import (attention, convert, encdec, layers, model_zoo, moe,  # noqa: F401
               ssm, transformer)
from .convert import params_from_jax  # noqa: F401
from .model_zoo import ModelAPI, build  # noqa: F401
