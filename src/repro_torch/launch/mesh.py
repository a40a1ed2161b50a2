"""Production and host meshes (functions, not module constants: importing
this module touches no device).

The port of `repro.launch.mesh`. A production mesh of 256 or 512 ranks is
by default a shape with axis names over ``torch.device("meta")``: the
rules (`parallel.sharding.spec_for`) and placements need only the axis
sizes. Over a real `device` it is that many logical shards of it, for a
world of threaded ranks (`parallel.local_world`).
"""
from __future__ import annotations

import math

import torch

from ..parallel.sharding import Mesh, _indexed


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 chips a pod; multi_pod adds the 2-pod leading axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = torch.device("meta") if device is None else _indexed(device)
    return Mesh((dev,) * math.prod(shape), axes, shape)


def make_host_mesh(max_devices: int | None = None, *, device=None,
                   n_shards: int | None = None) -> Mesh:
    """The squarest (data, model) mesh with model <= data: over the visible
    cards (at most `max_devices`), or over `n_shards` logical shards of
    `device` (default the current card)."""
    if n_shards is not None:
        devices = (_indexed("cuda" if device is None else device),) * int(n_shards)
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass device= and "
                               "n_shards= for logical shards of one device")
        n = n if max_devices is None else min(int(max_devices), n)
        devices = tuple(torch.device("cuda", i) for i in range(n))
    n = len(devices)
    best = (n, 1)
    for m in range(1, int(n ** 0.5) + 1):
        if n % m == 0:
            best = (n // m, m)
    return Mesh(devices, ("data", "model"), best)
