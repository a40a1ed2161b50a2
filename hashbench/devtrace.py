"""Reading the profiler's trace of a window: device operations, busy
time and the idle gaps by what the host was doing.

The arithmetic of `chip_smoke.py::device_busy` (device operations by
name, busy time over the wall), kept here frozen, plus the union of the
device's intervals and the attribution of each gap between them to the
host's CUDA runtime call that covers it (the profiler records the card's
activity and the runtime calls that issue it, not the host's operators).
Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import dataclasses

import torch

#: a gap under no runtime call: the host in Python or in the loop
BETWEEN = "host outside the CUDA runtime"


@dataclasses.dataclass
class Trace:
    """What the readers of per-layer metrics read.

    batches:  the pool batch of each call made in the traced window
    ops:      [(name, start_s, end_s)] of each device operation
    window_s: the traced window's length on the host clock
    kind:     the card's name (`torch.cuda.get_device_name()`)
    host:     [(start_s, end_s, name)] of each host event, sorted
    """

    batches: list
    ops: list
    window_s: float
    kind: str
    host: list = dataclasses.field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.batches)

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return sum(e - s for s, e in merged(self.ops))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the host event that covers each gap's middle."""
        by_name: dict = {}
        for name, s, e in self.ops:
            key = name.split("(")[0][:120]
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        gaps: dict = {}
        starts = [h[0] for h in self.host]
        iv = merged(self.ops)
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            mid = (e0 + s1) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = self.host[i][2] if i >= 0 and self.host[i][1] >= mid else BETWEEN
            gaps[name] = gaps.get(name, 0.0) + (s1 - e0)
        order = lambda d: sorted(([k, v] for k, v in d.items()),
                                 key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(by_name), "idle_gaps": order(gaps)}


def merged(ops) -> list:
    """The union of the operations' intervals, as sorted (start, end)."""
    out: list = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read(prof, batches, window_s: float, kind: str) -> Trace:
    """A `Trace` from a stopped `torch.profiler.profile`."""
    ops, host = [], []
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((ev.name, s, e))
        else:
            host.append((s, e, ev.name))
    host.sort()
    return Trace(list(batches), ops, window_s, kind, host)
