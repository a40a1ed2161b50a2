"""Distribution substrate of the port: meshes, the parameter sharding rules
and placements, the data mesh that sharded hashing, the device-sharded
Bloom filter and the admission service run on. `parallel.collectives`
(int8 gradient compression, `hierarchical_psum`, the sharded step's
counted collectives) is not imported here: it draws its bits from
`quality.keygen`, which imports the hashing package that imports this one.
`parallel.local_world` runs a world of threaded ranks in one process."""
from . import sharding  # noqa: F401
from .sharding import (Mesh, NamedSharding, P, batch_sharding, constraint,  # noqa: F401
                       data_mesh, home_device, mesh_axis_size, param_shardings,
                       param_specs, use_mesh)
