"""Serving: slot-based continuous batching engine with hash prefix cache."""
from . import engine  # noqa: F401
from .engine import Request, ServeEngine  # noqa: F401
