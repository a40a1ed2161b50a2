"""Distribution substrate of the port: the data mesh that sharded hashing,
the device-sharded Bloom filter and the admission service run on."""
from . import sharding  # noqa: F401
from .sharding import Mesh, data_mesh, home_device, mesh_axis_size  # noqa: F401
