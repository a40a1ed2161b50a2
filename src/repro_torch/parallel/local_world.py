"""A world of ranks in one process: N threads, one rank each, over one
device, joined by PyTorch's threaded process group.

A machine with one card and no second process can still run the sharded
train step, the sharded restore and the collectives with real values:
every rank is a thread of this process, every rank's tensors live on the
same device, and the collectives of `torch.distributed` run through the
threaded backend of
`torch.testing._internal.distributed.multi_threaded_pg`. This module is
the only user of that private API; if it is missing, `run` raises (there
is no fallback to one rank). Under `torchrun` with NCCL the same package
code runs one rank a process.
"""
from __future__ import annotations

import threading

import torch

from .sharding import Mesh, device_mesh

# a world that does not finish in this time is reported as hung (its
# threads are daemons: they cannot keep the process alive)
TIMEOUT_S = 1800.0


def _threaded_api():
    try:
        from torch.testing._internal.distributed import multi_threaded_pg
    except ImportError as exc:  # pragma: no cover - depends on the build
        raise RuntimeError("this PyTorch build has no threaded process group "
                           "(torch.testing._internal.distributed."
                           "multi_threaded_pg); a world of ranks in one process "
                           "needs it") from exc
    for name in ("_install_threaded_pg", "_uninstall_threaded_pg", "ProcessLocalGroup"):
        if not hasattr(multi_threaded_pg, name):
            raise RuntimeError(f"multi_threaded_pg has no {name}")
    if not hasattr(torch._C._distributed_c10d, "_set_thread_isolation_mode"):
        raise RuntimeError("this PyTorch build has no _set_thread_isolation_mode: "
                           "threaded ranks would share one process-group registry")
    return multi_threaded_pg


def _isolate_threads(on: bool) -> None:
    """Per-thread process-group registries: without them the threaded
    ranks' collectives hang."""
    torch._C._distributed_c10d._set_thread_isolation_mode(on)


_LOCK = threading.Lock()  # one world at a time in a process


def run(fn, mesh: Mesh) -> list:
    """Run fn(rank) on `mesh.size` threaded ranks, each with its process
    group up, `mesh` current (`parallel.sharding.use_mesh`) and its named
    `DeviceMesh` built, and multithreaded autograd off in the rank (a
    backward then runs on the rank's thread, where its process group
    is). Returns the ranks' results in rank order; the first rank's
    exception is raised."""
    import torch.distributed as dist

    from .sharding import use_mesh

    mt = _threaded_api()
    n = mesh.size
    results, errors = [None] * n, [None] * n
    with _LOCK:
        _isolate_threads(True)
        mt.ProcessLocalGroup.reset()
        mt._install_threaded_pg()
        store = dist.HashStore()

        def rank_main(rank: int):
            # the rank's groups live in its thread's world and go with the
            # thread (destroy_process_group does not know that world in
            # every PyTorch build)
            try:
                dist.init_process_group("threaded", rank=rank, world_size=n, store=store)
                with torch.autograd.set_multithreading_enabled(False), use_mesh(mesh):
                    device_mesh(mesh)
                    results[rank] = fn(rank)
            except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
                errors[rank] = exc
                # release the ranks waiting in a collective for this one
                # (they stop with SystemExit) instead of hanging
                mt.ProcessLocalGroup.exception_handle(exc)

        threads = [threading.Thread(target=rank_main, args=(r,), daemon=True,
                                    name=f"rank{r}") for r in range(n)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT_S)
            hung = [t.name for t in threads if t.is_alive()]
        finally:
            mt._uninstall_threaded_pg()
            _isolate_threads(False)
    if hung:
        raise RuntimeError(f"ranks {hung} did not finish in {TIMEOUT_S} s")
    # the first rank's own failure, before the exits it caused
    for exc in sorted((e for e in errors if e is not None),
                      key=lambda e: isinstance(e, SystemExit)):
        raise exc
    return results
