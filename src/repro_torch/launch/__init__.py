"""Launchers of the port: mesh construction."""
from .mesh import make_host_mesh, make_production_mesh  # noqa: F401
