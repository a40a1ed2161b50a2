"""Model zoo of the port: layers, attention, the block-structured LM and
the weight carry-over from the reference (`convert.params_from_jax`)."""
from . import attention, convert, layers, model_zoo, transformer  # noqa: F401
from .convert import params_from_jax  # noqa: F401
from .model_zoo import ModelAPI, build  # noqa: F401
