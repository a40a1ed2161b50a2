"""Launchers of the port: mesh construction and the multi-pod dry run
(`python -m repro_torch.launch.dryrun`, over a fake world; unlike the
reference's it needs no fresh process: it pins no device count). The dry
run's entry points load with their module, on first use."""
from .mesh import make_host_mesh, make_production_mesh  # noqa: F401

_DRYRUN = ("build_cell", "run_cell", "main")


def __getattr__(name):
    if name in _DRYRUN:
        from . import dryrun

        return getattr(dryrun, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
