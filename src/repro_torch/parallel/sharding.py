"""The data mesh: a single-controller, in-process counterpart of the
reference's 1-D ('data',) `jax.sharding.Mesh`.

A `Mesh` is a tuple of `torch.device`s along the axis ``"data"``. One
Python object takes a global batch, runs each shard's part on that shard's
device and returns global results, as the reference's `shard_map` does. A
device may appear several times: D *logical shards* of one device are the
port's counterpart of XLA's fake host devices, so the routed bucketing,
the exchange and the owned-range scatter of `hash.distributed` run at any
D on one card (or on the CPU in the tests). Only the two helpers the
sharded admission path needs are here (`src/repro/parallel/sharding.py`
:267, :278).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along named axes; hashable, so it can key caches."""

    devices: "tuple[torch.device, ...]"
    axis_names: "tuple[str, ...]" = ("data",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(map(_indexed, self.devices)))

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(device) -> torch.device:
    """A CUDA device with its index (tensors report one; `cuda` alone would
    compare unequal to `cuda:0`)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(max_devices: int | None = None, *, device=None,
              n_shards: int | None = None) -> Mesh:
    """1-D ('data',) mesh.

    - default (`device` None or ``"cuda"`` without an index): every visible
      CUDA device, one shard each, at most `max_devices`; raises without a
      card;
    - another `device` (``"cpu"``, ``"cuda:1"``): that device alone;
    - `n_shards=D`: D logical shards of ONE device (`device`, default the
      current CUDA device).
    """
    if n_shards is not None:
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        return Mesh((_indexed("cuda" if device is None else device),)
                    * int(n_shards))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if max_devices is not None:
            n = min(n, int(max_devices))
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((dev,))


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    """Extent of `name` in `mesh` (1 if absent -- degenerate degrade)."""
    return mesh.size if name in mesh.axis_names else 1


def home_device(mesh: Mesh | None, device=None) -> torch.device:
    """Where a consumer with an optional mesh keeps its own tensors: the
    `device` it was given, else the mesh's first device, else the card."""
    if device is None and mesh is not None:
        return mesh.devices[0]
    return resolve_device(device)
