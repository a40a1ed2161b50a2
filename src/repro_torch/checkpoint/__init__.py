"""Checkpointing with tree-fingerprint integrity (the reference's tree-v1
files, readable by either package)."""
from . import checkpointer  # noqa: F401
from .checkpointer import (  # noqa: F401
    Checkpointer, CorruptCheckpointError, UnsupportedManifestScheme,
    migrate_legacy_manifest)
