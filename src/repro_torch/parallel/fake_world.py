"""A fake world: rank 0 of N ranks, in one process, with no peers.

The counterpart of the reference dry run's 512 fake host devices
(`repro.launch.dryrun`, which pins `--xla_force_host_platform_device_count`
before JAX starts). PyTorch's ``"fake"`` process-group backend
(`torch.testing._internal.distributed.fake_pg`) answers every collective
at once without moving a byte: with tensors of `FakeTensorMode` (shapes,
no storage) the program of one rank of a 256- or 512-rank mesh runs in
one process, its collectives issued with the shapes and groups they would
have, so a census (`launch.op_analysis`) can count what the rank computes
and communicates. This module is the only user of that private API, as
`parallel.local_world` is of the threaded group; if it is missing,
`fake_world` raises (there is no fallback to a world of one rank).

Rank 0 stands for every rank, as the reference's per-device SPMD program
does. The cells of `launch.dryrun` give every rank the same shapes (every
sharded dim splits evenly: the rules replicate a dim its axes do not
divide), so the counts of rank 0 are every rank's, with one exception:
a decode step writes its new key and value into the one chunk of the
cache's sequence dim that holds the position
(`models.attention.cache_insert`), so the rank holding that chunk copies
(B, 1, Hkv, dh) more than the others; the dry run writes the last
position, which rank 0 does not hold.
"""
from __future__ import annotations

import contextlib

from .sharding import Mesh, clear_device_meshes, device_mesh, use_mesh


def _fake_api():
    try:
        from torch.testing._internal.distributed import fake_pg
    except ImportError as exc:  # pragma: no cover - depends on the build
        raise RuntimeError("this PyTorch build has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg); "
                           "a fake world needs it") from exc
    if not hasattr(fake_pg, "FakeStore"):
        raise RuntimeError("torch.testing._internal.distributed.fake_pg has no "
                           "FakeStore")
    return fake_pg


@contextlib.contextmanager
def fake_world(mesh: Mesh):
    """Start the ``"fake"`` process group as rank 0 of `mesh.size` ranks,
    make `mesh` current and build its named `DeviceMesh` (on the type of
    `mesh`'s devices; the meta device counts as "cpu"); yield that
    `DeviceMesh`. On exit the group is destroyed and the cache of
    `DeviceMesh`es cleared (it is keyed on the group's `id()`, which Python
    may give the next group). Refuses to start while a default group is
    live."""
    import torch.distributed as dist

    fake_pg = _fake_api()
    if dist.is_initialized():
        raise RuntimeError("a default process group is live; a fake world "
                           "cannot start beside it")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        with use_mesh(mesh):
            yield device_mesh(mesh)
    finally:
        dist.destroy_process_group()
        clear_device_meshes()
