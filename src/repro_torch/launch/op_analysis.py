"""An op census: what one rank's program computes, moves and holds, counted
as it runs.

The port's counterpart of `repro/launch/hlo_analysis.py`. The reference
compiles a cell and reads its HLO text: dot FLOPs, transcendentals and
collective bytes, multiplied up the call graph by the trip counts of the
while loops (XLA's `cost_analysis` visits a loop body once). The port
runs eagerly, so there is no HLO and no loop to correct: a
`TorchDispatchMode` sees every operation once per run, on real tensors or
on fake ones (`FakeTensorMode`, over `parallel.fake_world`), and counts

  - dot FLOPs: 2 x (result elements) x (contracted extent) of every matrix
    product (`mm`, `addmm`, `bmm`, `baddbmm`, `mv`, `dot`; `einsum`,
    `matmul` and `linear` reach the census as these), the ops
    `hlo_analysis._dot_flops` counts;
  - transcendental elements: `exp`, `log`, `tanh`, `rsqrt`, `sigmoid`
    (`hlo_analysis.py`'s exponential, log, tanh, rsqrt, logistic), and the
    fused ops that compute them element by element (`_softmax`,
    `logsumexp`, `silu`; the tanh form of `gelu`);
  - the bytes each op reads and writes (its tensor arguments and results;
    views move none);
  - each collective -- a call of `torch.distributed`'s (the sharded train
    step's, the flash-decoding combine's) or a functional collective of
    DTensor's redistributions -- under the reference's five names
    (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute; `send` and the like are not used), with its
    per-device RESULT bytes, as the reference counts them
    (`dryrun.collective_bytes`): an all-gather's result is n times its
    input. Beside them, `traffic`: the bytes the rank sends by the ring
    algorithm, as `parallel.collectives` counts them (an all-gather
    (n - 1)/n of its result, a reduce-scatter (n - 1)/n of its input, an
    all-reduce twice (n - 1)/n of its tensor, over n ranks);
  - peak live bytes: every storage an op creates is live until it is
    freed (a `weakref.finalize` on the storage, fake ones too), on top of
    the storages of the arguments the census is given.

Operations on DTensors are counted at the level of their local shards
(the census steps aside for the DTensor layer, so the local ops and the
collectives of its redistributions reach it); the operations DTensor's
sharding propagation runs on fake tensors of the global shape to learn an
output's metadata are not the rank's work and are not counted.

All numbers are PER RANK: the rank whose thread entered the census.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten


def _numel(t) -> int:
    return math.prod(t.shape)


def _nbytes(t) -> int:
    return _numel(t) * t.element_size()


# dot FLOPs: op -> f(args) (2 x result elements x contracted extent)
def _mm(a, b, *_):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b, *_):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


_DOTS = {
    aten.mm: lambda args: _mm(args[0], args[1]),
    aten.addmm: lambda args: _mm(args[1], args[2]),
    aten.bmm: lambda args: _bmm(args[0], args[1]),
    aten.baddbmm: lambda args: _bmm(args[1], args[2]),
    aten.mv: lambda args: 2 * _numel(args[0]),
    aten.addmv: lambda args: 2 * _numel(args[1]),
    aten.dot: lambda args: 2 * _numel(args[0]),
    aten.vdot: lambda args: 2 * _numel(args[0]),
}


# transcendental elements: op -> f(args, out)
def _out_elems(args, out):
    return _numel(out)


def _in_elems(args, out):
    return _numel(args[0])


_TRANSCENDENTALS = {
    **{op: _out_elems for op in (aten.exp, aten.exp_, aten.log, aten.log_,
                                 aten.tanh, aten.tanh_, aten.rsqrt, aten.rsqrt_,
                                 aten.sigmoid, aten.sigmoid_, aten.silu,
                                 aten.silu_)},
    aten._softmax: _in_elems,                                   # exp a element
    aten.logsumexp: lambda args, out: _numel(args[0]) + _numel(out),  # exp, log
    aten.gelu: lambda args, out: (_numel(out) if len(args) > 1 and args[1] == "tanh"
                                  else 0),
}


def _group_size(args, name_index: int | None = None, size_index: int | None = None):
    """The ranks of a functional collective's group: given (its size
    argument) or looked up by name."""
    if size_index is not None:
        return int(args[size_index])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[name_index]).size()


def _flat(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _sum_bytes(ts) -> int:
    return sum(_nbytes(t) for t in _flat(ts))


# collectives: op name -> (kind, f(args) -> (result bytes, sent bytes))
def _gather(out, n):
    r = _sum_bytes(out)
    return r, r * (n - 1) // n


def _scatter(out, inp, n):
    return _sum_bytes(out), _sum_bytes(inp) * (n - 1) // n


def _reduce(t, n):
    b = _sum_bytes(t)
    return b, 2 * b * (n - 1) // n


_FUNCTIONAL = {
    # _c10d_functional::op(input, ...) -> result
    "all_gather_into_tensor": ("all-gather",
                               lambda a, o: _gather(o, _group_size(a, size_index=1))),
    "all_gather_into_tensor_coalesced": (
        "all-gather", lambda a, o: _gather(o, _group_size(a, size_index=1))),
    "all_reduce": ("all-reduce", lambda a, o: _reduce(o, _group_size(a, name_index=2))),
    "all_reduce_": ("all-reduce", lambda a, o: _reduce(o, _group_size(a, name_index=2))),
    "all_reduce_coalesced": ("all-reduce",
                             lambda a, o: _reduce(o, _group_size(a, name_index=2))),
    "all_reduce_coalesced_": ("all-reduce",
                              lambda a, o: _reduce(o, _group_size(a, name_index=2))),
    "reduce_scatter_tensor": ("reduce-scatter",
                              lambda a, o: _scatter(o, a[0], _group_size(a, size_index=2))),
    "reduce_scatter_tensor_coalesced": (
        "reduce-scatter", lambda a, o: _scatter(o, a[0], _group_size(a, size_index=2))),
    "all_to_all_single": ("all-to-all",
                          lambda a, o: _scatter(o, a[0], _group_size(a, name_index=3))),
}


# ---------------------------------------------------------------------------
# DTensor's planning -- its sharding propagation (which runs ops on fake
# tensors of the global shape to learn an output's metadata), its search
# for a redistribution and the index arithmetic of a strided shard -- works
# on shapes, with small tensors of its own: not the rank's work. The census
# mutes itself there (a thread's own count), and the planning runs outside
# any `FakeTensorMode` of the caller's (its index tensors must hold values).
# ---------------------------------------------------------------------------

_MUTE = threading.local()
_PATCH_LOCK = threading.Lock()
_PATCH = {"users": 0, "orig": []}


def _muted() -> bool:
    return getattr(_MUTE, "depth", 0) > 0


def _api_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


# torch.distributed's collectives: name -> (kind, f(bound args) -> (result
# bytes, sent bytes)); `*_single` are PyTorch 2.13's names of the
# one-tensor gather and scatter
def _api_gather(a):
    return _gather(a["output_tensor"], _api_size(a.get("group")))


def _api_scatter(a):
    return _scatter(a["output"], a["input"], _api_size(a.get("group")))


_API = {
    "all_gather_into_tensor": ("all-gather", _api_gather),
    "all_gather_single": ("all-gather", _api_gather),
    "all_gather": ("all-gather", lambda a: _gather(a["tensor_list"],
                                                   _api_size(a.get("group")))),
    "reduce_scatter_tensor": ("reduce-scatter", _api_scatter),
    "reduce_scatter_single": ("reduce-scatter", _api_scatter),
    "all_reduce": ("all-reduce", lambda a: _reduce(a["tensor"], _api_size(a.get("group")))),
    "all_to_all_single": ("all-to-all", _api_scatter),
}
_ACTIVE = threading.local()  # the census stack of a thread


def _counted(name: str, fn):
    import inspect

    kind, sizes = _API[name]
    sig = inspect.signature(fn)

    def counted(*args, **kwargs):
        stack = getattr(_ACTIVE, "stack", None)
        outer = not getattr(_ACTIVE, "inside", False)
        _ACTIVE.inside = True
        try:
            out = fn(*args, **kwargs)
        finally:
            _ACTIVE.inside = not outer
        if outer and stack and not _muted():
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            stack[-1].collective(kind, *sizes(bound.arguments))
        return out

    return counted


def _planning_functions() -> list:
    """[(owner, name)] of DTensor's planning entry points."""
    from torch.distributed.tensor import _redistribute, _sharding_prop, placement_types

    return [(_sharding_prop.ShardingPropagator, "_propagate_tensor_meta_non_cached"),
            (_sharding_prop.ShardingPropagator, "propagate_op_sharding_non_cached"),
            (_redistribute, "_gen_transform_infos_non_cached"),
            (placement_types._StridedShard, "local_shard_size_and_offset")]


def _planning(fn):
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def planned(*args, **kwargs):
        _MUTE.depth = getattr(_MUTE, "depth", 0) + 1
        try:
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _MUTE.depth -= 1

    return planned


def _install_mute() -> None:
    import torch.distributed as dist

    with _PATCH_LOCK:
        if _PATCH["users"] == 0:
            for owner, name in _planning_functions():
                raw = owner.__dict__[name]
                _PATCH["orig"].append((owner, name, raw))
                fn = raw.__func__ if isinstance(raw, staticmethod) else raw
                wrapped = _planning(fn)
                setattr(owner, name, staticmethod(wrapped) if isinstance(raw, staticmethod)
                        else wrapped)
            for name in _API:
                if hasattr(dist, name):
                    _PATCH["orig"].append((dist, name, getattr(dist, name)))
                    setattr(dist, name, _counted(name, getattr(dist, name)))
        _PATCH["users"] += 1


def _remove_mute() -> None:
    with _PATCH_LOCK:
        _PATCH["users"] -= 1
        if _PATCH["users"] == 0:
            for owner, name, raw in reversed(_PATCH["orig"]):
                setattr(owner, name, raw)
            _PATCH["orig"].clear()


@contextlib.contextmanager
def dtensor_planning():
    """Keep DTensor's planning (above) out of the census and of any
    `FakeTensorMode` while inside: a dry run over fake tensors needs it
    from the first DTensor op on, census or not."""
    _install_mute()
    try:
        yield
    finally:
        _remove_mute()


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def local_tensors(tree) -> list:
    """The tensors of a tree, each DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    from ..core.pytree import flatten_with_paths

    out = []
    for _, x in flatten_with_paths(_nested(tree)):
        if isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nested(tree):
    from torch import nn

    if isinstance(tree, nn.Module):
        return {k: v for k, v in tree.state_dict(keep_vars=True).items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _nested(x) for i, x in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _nested(v) for k, v in tree.items()}
    return tree


def tree_bytes(tree) -> int:
    """Bytes of the rank's local chunks of every tensor in `tree`."""
    return sum(_nbytes(t) for t in local_tensors(tree))


class Census(TorchDispatchMode):
    """Counts the operations of the thread that enters it (module
    docstring). `arguments`: trees whose storages are live before the run
    (the cell's inputs): peak live bytes start from their bytes, and an op
    writing into them allocates nothing."""

    def __init__(self, arguments=()):
        super().__init__()
        self.dot_flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.n_ops = 0
        self.coll = {c: {"count": 0, "bytes": 0, "traffic": 0} for c in COLLECTIVES}
        self.by_op = collections.defaultdict(lambda: [0, 0, 0, 0])  # calls flops trans bytes
        self._lock = threading.RLock()
        self._live = {}
        args = local_tensors(arguments)
        for t in args:
            self._keep(t)
        self.argument_bytes = sum(_nbytes(t) for t in args)
        self.live_bytes = sum(self._live.values())
        self.peak_bytes = self.live_bytes

    # -- storages --------------------------------------------------------
    def _keep(self, t) -> bool:
        """Track t's storage; True if it was not tracked yet."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return False
        nbytes = st.nbytes()
        self._live[key] = nbytes
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch --------------------------------------------------------
    def __enter__(self):
        _install_mute()
        try:
            out = super().__enter__()
        except BaseException:
            _remove_mute()
            raise
        _ACTIVE.stack = getattr(_ACTIVE, "stack", []) + [self]
        return out

    def __exit__(self, *exc):
        _ACTIVE.stack = _ACTIVE.stack[:-1]
        try:
            return super().__exit__(*exc)
        finally:
            _remove_mute()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _muted():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        if ns == "prim":
            return
        packet = func._overloadpacket
        entry = self.by_op[str(packet)]
        entry[0] += 1
        self.n_ops += 1
        if ns in ("c10d", "_c10d_functional"):
            # the c10d ops are counted where `torch.distributed` is called
            # (`_API`: a Python process group, the threaded one, reaches no
            # c10d op), the functional ones (DTensor's) here
            if ns == "_c10d_functional" and packet.__name__ in _FUNCTIONAL:
                kind, fn = _FUNCTIONAL[packet.__name__]
                self.collective(kind, *fn(args, out))
            return
        flops = _DOTS[packet](args) if packet in _DOTS else 0
        trans = _TRANSCENDENTALS[packet](args, out) if packet in _TRANSCENDENTALS else 0
        ins = _flat((args, kwargs))
        outs = _flat(out)
        moved = 0
        if not func.is_view:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.dot_flops += flops
        self.transcendentals += trans
        self.bytes_accessed += moved
        entry[1] += flops
        entry[2] += trans
        entry[3] += moved
        if func.is_view or not outs:
            return
        in_storages = {t.untyped_storage()._cdata for t in ins}
        with self._lock:
            for t in outs:
                if t.untyped_storage()._cdata not in in_storages and self._keep(t):
                    self.live_bytes += self._live[t.untyped_storage()._cdata]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def collective(self, kind: str, result: int, sent: int) -> None:
        c = self.coll.setdefault(kind, {"count": 0, "bytes": 0, "traffic": 0})
        c["count"] += 1
        c["bytes"] += result
        c["traffic"] += sent

    # -- results ---------------------------------------------------------
    def totals(self) -> dict:
        """The reference's `hlo_analysis.totals` keys, per rank, and the
        census's own: `traffic_per_device` (bytes sent), `bytes_accessed`,
        `peak_bytes`, `argument_bytes`, `n_ops`."""
        coll = {k: dict(v) for k, v in self.coll.items() if v["count"]}
        return {
            "dot_flops_per_device": float(self.dot_flops),
            "transcendentals_per_device": float(self.transcendentals),
            "collectives": coll,
            "collective_bytes_per_device": float(sum(v["bytes"] for v in coll.values())),
            "traffic_per_device": int(sum(v["traffic"] for v in coll.values())),
            "bytes_accessed": float(self.bytes_accessed),
            "peak_bytes": int(self.peak_bytes),
            "argument_bytes": int(self.argument_bytes),
            "n_ops": int(self.n_ops),
        }

    def ops(self) -> list:
        """[{op, calls, flops, transcendentals, bytes}], most bytes first:
        the per-op census (`dryrun --save-ops`)."""
        rows = [{"op": k, "calls": v[0], "flops": v[1], "transcendentals": v[2],
                 "bytes": v[3]} for k, v in self.by_op.items()]
        return sorted(rows, key=lambda r: (-r["bytes"], -r["flops"], r["op"]))


@contextlib.contextmanager
def census(arguments=()):
    """`with census(args) as c: ...` then `c.totals()`."""
    c = Census(arguments)
    with c:
        yield c
