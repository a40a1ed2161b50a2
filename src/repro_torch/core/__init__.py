"""Keys, host twins and int64 tensor arithmetic of the PyTorch port."""
from . import device, gf, hostref, keys, limbs, multilinear, pytree, theory  # noqa: F401
