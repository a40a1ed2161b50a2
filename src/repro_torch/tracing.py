"""The port's recorder: spans and counters on the hash path.

Off by default, with no environment variable or setting: `enable(capacity)`
starts a recording, `disable()` stops it, `snapshot()` returns what it
holds and `reset()` empties it.

- A **span** is one pass through a layer boundary: its name, start and end
  on the clock of `torch.profiler`'s events (Unix nanoseconds,
  `time.time_ns`), the span of the same thread that encloses it, and the
  call it belongs to (the id of its thread's outermost span, so every span
  of one call shares it). Spans go into storage of `capacity` records
  preallocated by `enable()`; the records that do not fit are counted
  under `tracing.dropped`. While tracing is off a span site costs one test
  of the module flag `ON` (no clock read, no allocation, no torch call):

      sp = tracing.begin("launch.multihash") if tracing.ON else None
      try:
          ...
      finally:
          if sp is not None:
              tracing.end(sp)

- A **counter** is a named integer (`counter(name)`). The launch counters
  (`launch.*`, made with `always=True`) count whether tracing is on or off
  and are zeroed only by their modules' `reset_count()`; every other
  counter is added to only while tracing is on and zeroed by `reset()`.
- The engine kernels count their own columns into a buffer on each card
  (`engine_counts`): `engine.lane_columns` (32 for each column a warp
  hashes) and `engine.live_columns` (the columns inside its rows), in
  `ENGINE_SLOTS` pairs that `snapshot()` sums with one copy to the host a
  card.

`totals(snapshot())` gives each span name's count, summed duration and
summed self time. `enable`, `reset` and `snapshot` belong between calls,
not inside one: a span open across them is lost.

The spans and counters of the hash path:

    hasher.hash_slots     Hasher._hash_slots, the root of a Hasher call
    launch.multihash      kernels.ops.multihash: family dispatch and wrapper
    launch.c              kernels._build.launch: the C launcher's call alone
    launch.dispatch       engine dispatches (kernels.ops.launch_count)
    launch.<kernel>       CUDA launches of each kernel wrapper
    engine.slot_bytes     bytes of the engine's slots and split partials
    engine.ordered_calls  engine calls whose rows ran in length order
    engine.lane_columns   lane columns the engine hashed
    engine.live_columns   of those, columns inside the rows
    tracing.dropped       spans that found their storage full
"""
from __future__ import annotations

import itertools
import time
from array import array
from threading import get_ident
from typing import NamedTuple

import torch

#: True while a recording runs; the one test a span site makes
ON = False
#: the span clock: Unix nanoseconds, as torch.profiler stamps its events
clock = time.time_ns


class Counter:
    """A count, `n`, that its owner adds to; `always`: it counts whether
    tracing is on or off, and `reset()` leaves it."""

    __slots__ = ("n", "always")

    def __init__(self, always: bool):
        self.n, self.always = 0, always


class Span(NamedTuple):
    id: int              # its record's index in the recording
    name: str
    start_ns: int
    end_ns: int | None   # None while open
    parent: int          # id of the enclosing span of its thread, or -1
    call: int            # id of its thread's outermost span
    thread: int          # threading.get_ident() of its thread


_COUNTERS: dict[str, Counter] = {}


def counter(name: str, *, always: bool = False) -> Counter:
    """The counter `name`, made on first use."""
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = Counter(always)
    return c


_DROPPED = counter("tracing.dropped")
_ENGINE_NAMES = ("engine.lane_columns", "engine.live_columns")
#: the engine's count buffer: pairs (lane, live) a row apart, so warps add
#: to different lines (csrc/engine_tile.cuh's ET_STAT_SLOTS, ET_STAT_STRIDE)
ENGINE_SLOTS = (64, 32)
_engine: dict[torch.device, torch.Tensor] = {}  # card -> its count buffer

_cap = 0
_seq = itertools.count()
# the records, one column each, preallocated by `enable`: a span allocates
# nothing that outlives it, so a recording does not grow the heap
_name = array("H")
_parent = array("q")
_call = array("q")
_thread = array("Q")
_start = array("q")
_end = array("q")  # -1 while open
_names: dict[str, int] = {}  # span name -> its index in _NAMES
_NAMES: list[str] = [""]  # 0: no record
_stacks: dict[int, list] = {}  # thread -> ids of its open spans, outermost first


def _name_id(name: str) -> int:
    n = _names.get(name)
    if n is None:
        n = _names[name] = len(_NAMES)
        _NAMES.append(name)
    return n


def begin(name: str) -> int:
    """Open span `name` on this thread; returns its id for `end`."""
    i = next(_seq)
    t = get_ident()
    st = _stacks.get(t)
    if st is None:
        st = _stacks[t] = []
    if i < _cap:
        _name[i] = _name_id(name)
        _thread[i] = t
        if st:
            _parent[i], _call[i] = st[-1], st[0]
        else:
            _parent[i], _call[i] = -1, i
        _start[i] = clock()
    else:
        _DROPPED.n += 1
    st.append(i)
    return i


def end(i: int) -> None:
    """Close span `i` (and any span of this thread left open inside it)."""
    t = clock()
    st = _stacks.get(get_ident())
    while st and st.pop() != i:
        pass
    if i < _cap:
        _end[i] = t


def engine_counts(device) -> torch.Tensor:
    """The engine's count buffer on card `device` (`ENGINE_SLOTS` int64),
    made zeroed on first use."""
    buf = _engine.get(device)
    if buf is None:
        buf = torch.zeros(ENGINE_SLOTS, dtype=torch.int64, device=device)
        _engine[device] = buf
    return buf


def reset() -> None:
    """Empty the recording: its spans, the counters that count only while
    tracing is on, and the engine's buffers (one memset a card)."""
    global _seq, _name, _parent, _call, _thread, _start, _end, _stacks
    _seq = itertools.count()
    _name = array("H", bytes(2 * _cap))
    _parent, _call, _thread, _start = (array(c, bytes(8 * _cap)) for c in "qqQq")
    _end = array("q", [-1]) * _cap
    _stacks = {}
    for c in _COUNTERS.values():
        if not c.always:
            c.n = 0
    for buf in _engine.values():
        buf.zero_()


def enable(capacity: int = 1 << 16) -> None:
    """Start a new recording with room for `capacity` spans. Where the
    process already uses a card, its engine buffer is made (or zeroed) here,
    so the first traced launch puts no extra operation on the card."""
    global ON, _cap
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    ON = False
    _cap = int(capacity)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        engine_counts(torch.device("cuda", torch.cuda.current_device()))
    reset()
    ON = True


def disable() -> None:
    """Stop recording; what was recorded stays for `snapshot()`."""
    global ON
    ON = False


def snapshot() -> dict:
    """The recording: {"clock": "time_ns", "capacity": n, "spans": [Span]
    in id order, "counters": {name: value}}. Reads each card's engine
    buffer (a copy to the host, which waits for the card's work)."""
    spans = [Span(i, _NAMES[_name[i]], _start[i], None if _end[i] < 0 else _end[i],
                  _parent[i], _call[i], _thread[i])
             for i in range(_cap) if _name[i]]
    counts = {name: c.n for name, c in sorted(_COUNTERS.items())}
    engine = [0, 0]
    for buf in _engine.values():
        engine = [a + b for a, b in zip(engine, buf[:, :2].sum(0).tolist())]
    counts.update(zip(_ENGINE_NAMES, engine))
    return {"clock": "time_ns", "capacity": _cap, "spans": spans,
            "counters": counts}


def totals(snap: dict) -> dict:
    """Per span name of a snapshot, over its closed spans: {"spans": count,
    "total_ns": summed durations, "self_ns": summed self times}. A span's
    self time is its duration less its children's (spans of one thread
    nest, so its children never overlap)."""
    spans = {s.id: s for s in snap["spans"] if s.end_ns is not None}
    child = dict.fromkeys(spans, 0)
    for s in spans.values():
        if s.parent in child:
            child[s.parent] += s.end_ns - s.start_ns
    out: dict = {}
    for s in spans.values():
        d = s.end_ns - s.start_ns
        t = out.setdefault(s.name, {"spans": 0, "total_ns": 0, "self_ns": 0})
        t["spans"] += 1
        t["total_ns"] += d
        t["self_ns"] += d - child[s.id]
    return out
