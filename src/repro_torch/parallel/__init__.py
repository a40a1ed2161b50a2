"""Distribution substrate of the port: the data mesh that sharded hashing,
the device-sharded Bloom filter and the admission service run on; the int8
gradient compression of the train step is `parallel.collectives` (not
imported here: it draws its bits from `quality.keygen`, which imports the
hashing package that imports this one)."""
from . import sharding  # noqa: F401
from .sharding import Mesh, data_mesh, home_device, mesh_axis_size  # noqa: F401
