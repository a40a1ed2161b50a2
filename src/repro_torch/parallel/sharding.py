"""Meshes, the parameter sharding rules and placements: DP / FSDP / TP / EP
on (pod, data, model).

The port of `repro.parallel.sharding`. A `Mesh` is devices along named
axes: a row-major shape over the axis names, and the flat tuple of its
devices in that order. A device may appear several times: D *logical
shards* of one device are the port's counterpart of XLA's fake host
devices, so the sharded hashing of `hash.distributed` runs at any D on one
card (or on the CPU in the tests), and a production mesh is a shape over
``torch.device("meta")`` (no memory, no process group).

Parameter specs are pure functions of (path, shape, axis sizes), from the
reference's rules table (`PARAM_RULES`, `SERVING_OVERRIDES`) exactly. A
spec `P` is a tuple of entries, each None, an axis name or a tuple of
names, equal to ``tuple(jax.sharding.PartitionSpec(...))``. The rules see
the reference's stacked paths (``blocks/...``, leading scan dim
replicated); the port holds blocks as lists, so over a port `ParamTree`
each per-block tensor takes its stacked leaf's spec without the leading
None (`param_specs`).

Axis semantics:
  pod    -- data parallelism across pods (slow links)
  data   -- data parallelism within a pod; FSDP weight sharding
  model  -- tensor parallelism (heads / ffn / vocab) and expert parallelism

A `NamedSharding` gives each mesh coordinate its chunk (the global index
ranges it holds, as JAX's `devices_indices_map`) and the DTensor
placements of the same layout. The sharded train step and the sharded
restore run one rank per mesh coordinate over whatever `torch.distributed`
process group is live (`device_mesh`); under a mesh with such a group,
`batch_mean` takes a mean over the batch ranks (the MoE balance loss's
token means) and `constraint` redistributes a DTensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading

import torch

from ..core.device import resolve_device

_STATE = threading.local()


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along named axes; hashable, so it can key caches.

    `devices` is flat, row-major over `dims` (default: one axis of all the
    devices); `shape` maps each axis name to its extent, as the
    reference's `Mesh.shape` does."""

    devices: "tuple[torch.device, ...]"
    axis_names: "tuple[str, ...]" = ("data",)
    dims: "tuple[int, ...] | None" = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(map(_indexed, self.devices)))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        dims = (len(self.devices),) if self.dims is None else tuple(map(int, self.dims))
        if len(dims) != len(self.axis_names) or math.prod(dims) != len(self.devices):
            raise ValueError(f"mesh shape {dims} over axes {self.axis_names} does not "
                             f"hold {len(self.devices)} devices")
        object.__setattr__(self, "dims", dims)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    def coords(self, rank: int) -> dict:
        """{axis: index} of flat (row-major) position `rank`."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            rank, out[name] = divmod(rank, n)
        return {name: out[name] for name in self.axis_names}


def _indexed(device) -> torch.device:
    """A CUDA device with its index (tensors report one; `cuda` alone would
    compare unequal to `cuda:0`); the meta device as it is."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
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
    return int(mesh.shape.get(name, 1))


def home_device(mesh: Mesh | None, device=None) -> torch.device:
    """Where a consumer with an optional mesh keeps its own tensors: the
    `device` it was given, else the mesh's first device, else the card."""
    if device is None and mesh is not None:
        return mesh.devices[0]
    return resolve_device(device)


# ---------------------------------------------------------------------------
# the live mesh
# ---------------------------------------------------------------------------

def current_mesh() -> Mesh | None:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make `mesh` current in this thread (each rank of a threaded world
    sets its own)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def axis(name: str):
    """Return `name` if present in the current mesh, else None (spec no-op)."""
    m = current_mesh()
    if m is None or name not in m.axis_names:
        return None
    return name


def batch_axes():
    """Batch shards over ('pod','data') when both exist, else ('data',)."""
    m = current_mesh()
    if m is None:
        return None
    names = [n for n in ("pod", "data") if n in m.axis_names]
    return tuple(names) if names else None


def seq_axis(T: int, x=None):
    """'model' if the live mesh can evenly shard a length-T sequence dim,
    else None (decode steps with T=1, odd tails, or no mesh). None too for
    a DTensor activation `x`: sharded serving keeps the sequence whole
    (PyTorch 2.11's DTensor cannot fold a sharded sequence dim into the
    batch dim of a matrix product)."""
    m = current_mesh()
    if m is None or "model" not in m.axis_names or is_dtensor(x):
        return None
    size = m.shape["model"]
    return "model" if T % size == 0 and T >= size else None


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry a tensor dimension, each None
    (replicated), an axis name or a tuple of names (major first). Equal
    to the tuple of the reference's `PartitionSpec` of the same entries;
    missing trailing entries are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# Parameter sharding rules: (path regex, rank) -> spec template.
# Templates use symbols resolved against the live mesh:
#   D = fsdp axis ('data'), M = tensor axis ('model'), R = replicated (None),
#   D! = the data axis even in serving mode.
# First match wins; default replicates.
PARAM_RULES: list[tuple[str, int, tuple]] = [
    # embeddings: (vocab, d_model) -- vocab TP + FSDP on d_model
    (r"embed/tok", 2, ("M", "D")),
    (r"lm_head", 2, ("D", "M")),          # (d_model, vocab)
    (r"embed/pos", 2, ("R", "D")),
    # hashed embedding compressed table (n_buckets, d_model)
    (r"embed/hashed", 2, ("M", "D")),
    # attention (fused-2D storage: (d_model, H*dh))
    (r"(attn|cross)/(wq|wk|wv)/w", 2, ("D", "M")),
    (r"(attn|cross)/wo/w", 2, ("M", "D")),
    (r"(attn|cross)/(wq|wk|wv|wo)/b", 1, ("R",)),
    # dense mlp
    (r"mlp/w_(gate|up)", 2, ("D", "M")),
    (r"mlp/w_down", 2, ("M", "D")),
    # moe experts: (n_experts, d_in, d_out) -- EP over model, FSDP inside
    (r"moe/(w_gate|w_up)", 3, ("M", "D", "R")),
    (r"moe/w_down", 3, ("M", "R", "D")),
    (r"moe/router", 2, ("D", "R")),       # (d_model, n_experts)
    (r"moe/shared", 2, ("D", "M")),       # shared-expert mlp handled as mlp
    # mamba
    (r"mamba/in_proj", 2, ("D", "M")),    # (d_model, 2*d_inner)
    (r"mamba/conv", 2, ("M", "R")),       # (d_inner, k)
    (r"mamba/x_proj", 2, ("M", "R")),     # (d_inner, dt_rank + 2*d_state)
    (r"mamba/dt_proj", 2, ("R", "M")),    # (dt_rank, d_inner)
    (r"mamba/(A_log|D)$", 2, ("M", "R")),
    (r"mamba/(A_log|D)$", 1, ("M",)),
    (r"mamba/out_proj", 2, ("M", "D")),
    (r"mamba/dt_bias", 1, ("M",)),
    # rwkv6
    (r"rwkv/w_(r|k|v|g)", 2, ("D", "M")),
    (r"rwkv/w_o", 2, ("M", "D")),
    (r"rwkv/(decay|bonus|mix)", None, ("M",)),  # per-channel vectors
    (r"rwkv/ffn_(k)", 2, ("D", "M")),
    (r"rwkv/ffn_(v|r)", 2, ("M", "D")),
    # norms / scalars: replicated
    (r"(norm|scale|bias|ln)", None, ()),
]

# Serving-mode overrides: MoE expert weights stay 2D-sharded even for
# inference (E over model, F over data).
SERVING_OVERRIDES: list[tuple[str, int, tuple]] = [
    (r"moe/(w_gate|w_up)", 3, ("M", "R", "D!")),
    (r"moe/w_down", 3, ("M", "D!", "R")),
]

_STACKED = re.compile(r"(^|/)(layers|blocks|enc_layers|dec_layers)(/|$)")


def _resolve(sym, fsdp_pods: bool, serving: bool = False):
    if sym == "D!":  # data axis regardless of serving mode
        return axis("data")
    if sym == "D":
        if serving:
            # TP-resident weights for inference: no FSDP dim
            return None
        names = [n for n in (("data", "pod") if fsdp_pods else ("data",)) if axis(n)]
        if not names:
            return None
        return names[0] if len(names) == 1 else tuple(names)
    if sym == "M":
        return axis("model")
    return None


def _axis_size(mesh: Mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(_axis_size(mesh, n) for n in name)
    return mesh.shape[name]


def spec_for(path: str, shape: tuple, fsdp_pods: bool = False,
             serving: bool = False) -> P:
    """Spec of a parameter at the reference's pytree `path` with its shape
    (a stacked leaf's blocks first) under the current mesh. Dims whose
    size the proposed axes do not divide are replicated instead."""
    ndim = len(shape)
    stacked = bool(_STACKED.search(path))
    eff_ndim = ndim - 1 if stacked else ndim
    eff_shape = tuple(shape[1:]) if stacked else tuple(shape)
    mesh = current_mesh()
    rules = (SERVING_OVERRIDES + PARAM_RULES) if serving else PARAM_RULES
    for pat, rank, template in rules:
        if re.search(pat, path) and (rank is None or rank == eff_ndim):
            syms = list(template)[:eff_ndim]
            syms += ["R"] * (eff_ndim - len(syms))
            spec = [_resolve(s, fsdp_pods, serving) for s in syms]
            if mesh is not None:
                spec = [s if (s is None or eff_shape[i] % _axis_size(mesh, s) == 0)
                        else None for i, s in enumerate(spec)]
            if stacked:
                spec = [None] + spec
            return P(*spec)
    return P(*([None] * ndim))


def tree_paths(tree) -> list:
    """Nested containers -> [(path, leaf)], '/'-joined keys (the port's
    flatten; a `ParamTree` is seen in the reference's layout)."""
    from ..core.pytree import flatten_with_paths

    return flatten_with_paths(_as_nested(tree))


def _as_nested(tree):
    from torch import nn

    from ..models.convert import nested

    return nested(tree) if isinstance(tree, nn.Module) else tree


def _shape(leaf) -> tuple:
    """A leaf's reference shape: a `Stack` of per-block tensors is the
    stacked leaf (blocks first)."""
    from ..models.convert import Stack

    if isinstance(leaf, Stack):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(getattr(leaf, "shape", ()))


def param_specs(params, fsdp_pods: bool = False, serving: bool = False):
    """Specs mirroring `params`. A nested dict in the reference's layout
    gives the reference's tree of specs; a port `ParamTree` gives its
    reference layout (`models.convert.nested`) with every stacked leaf a
    `Stack` of its per-block tensors' specs (the stacked spec without the
    leading None)."""
    from ..core.pytree import map_with_paths
    from ..models.convert import Stack

    def leaf(path, x):
        spec = spec_for(path, _shape(x), fsdp_pods, serving)
        return Stack([P(*spec[1:])] * len(x)) if isinstance(x, Stack) else spec

    return map_with_paths(leaf, _as_nested(params))


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: which chunk of a tensor each mesh coordinate
    holds."""

    mesh: Mesh
    spec: P

    def _dim_axes(self, ndim: int) -> list:
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        if len(spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than {ndim} dims")
        return [_names(e) for e in spec]

    def local_shape(self, shape) -> tuple:
        return tuple(n // _axis_size(self.mesh, axes) if axes else n
                     for n, axes in zip(shape, self._dim_axes(len(shape))))

    def chunk(self, shape, rank: int) -> tuple:
        """The global index ranges (one `slice` a dim) that flat mesh
        position `rank` holds: a dim over axes (a1, a2, ...) splits into
        their product of equal chunks, a1 major (JAX's
        `devices_indices_map`)."""
        at = self.mesh.coords(rank)
        out = []
        for n, axes in zip(shape, self._dim_axes(len(shape))):
            parts = _axis_size(self.mesh, axes) if axes else 1
            if n % parts:
                raise ValueError(f"dim of {n} does not split over {axes}")
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + at[a]
            c = n // parts
            out.append(slice(idx * c, (idx + 1) * c))
        return tuple(out)

    def local(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank `rank`'s chunk of the global tensor `t` (a view)."""
        return t[self.chunk(tuple(t.shape), rank)]

    def placements(self, ndim: int) -> tuple:
        """DTensor placements, one a mesh axis in mesh order, of this
        layout for a tensor of `ndim` dims. A dim over axes whose spec
        order is not the mesh's (``("data", "pod")`` on a (pod, data, ...)
        mesh) takes `_StridedShard` on the axes that a later mesh axis
        precedes in the spec, so each rank holds its `chunk`."""
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.placement_types import _StridedShard

        owner = {}
        for d, axes in enumerate(self._dim_axes(ndim)):
            for j, a in enumerate(axes):
                owner[a] = (d, axes[:j])
        order = {a: i for i, a in enumerate(self.mesh.axis_names)}
        out = []
        for a in self.mesh.axis_names:
            if a not in owner:
                out.append(Replicate())
                continue
            d, major = owner[a]
            split = math.prod(self.mesh.shape[b] for b in major if order[b] > order[a])
            out.append(_StridedShard(d, split_factor=split) if split > 1 else Shard(d))
        return tuple(out)

    def replicas(self, ndim: int) -> int:
        """How many ranks hold each chunk."""
        used = {a for axes in self._dim_axes(ndim) for a in axes}
        return math.prod(n for a, n in self.mesh.shape.items() if a not in used)


def param_shardings(params, mesh: Mesh, fsdp_pods: bool = False):
    """`param_specs` (training layout) under `mesh` as `NamedSharding`s."""
    from ..core.pytree import map_with_paths
    from ..models.convert import Stack

    with use_mesh(mesh):
        specs = param_specs(params, fsdp_pods)

    def leaf(_path, s):
        if isinstance(s, Stack):
            return Stack([NamedSharding(mesh, b) for b in s])
        return NamedSharding(mesh, s)

    return map_with_paths(leaf, specs)


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Input batch: dim 0 over ('pod','data') in mesh order, rest replicated."""
    names = tuple(n for n in ("pod", "data") if n in mesh.axis_names)
    return NamedSharding(mesh, P(names, *([None] * (ndim - 1))))


# ---------------------------------------------------------------------------
# the live process group
# ---------------------------------------------------------------------------

def device_mesh(mesh: Mesh):
    """The named `torch.distributed` `DeviceMesh` of `mesh`'s shape over the
    live default process group (whose world is one rank a mesh position),
    built once a rank (a collective call: every rank makes it together).
    The cache is keyed on the group's `id()`, which Python may reuse for a
    later group: `parallel.fake_world` clears it (`clear_device_meshes`)
    when a fake world ends, and a threaded rank's cache goes with its
    thread."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"a {mesh.shape} mesh needs a live process group of "
                           f"{mesh.size} ranks (parallel.local_world or torchrun)")
    cache = getattr(_STATE, "device_meshes", None)
    if cache is None:
        cache = _STATE.device_meshes = {}
    key = (id(dist.distributed_c10d._get_default_group()), mesh.axis_names, mesh.dims,
           mesh.devices[0].type)
    if key not in cache:
        cache[key] = init_device_mesh(mesh.devices[0].type, mesh.dims,
                                      mesh_dim_names=mesh.axis_names)
    return cache[key]


def clear_device_meshes() -> None:
    """Forget this thread's `DeviceMesh`es (their group is gone)."""
    _STATE.device_meshes = {}


def live(mesh: Mesh | None) -> bool:
    """Whether `mesh` has a live process group of its size (one rank a
    position)."""
    import torch.distributed as dist

    return (mesh is not None and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == mesh.size)


class _BatchSum(torch.autograd.Function):
    """All-reduce (sum) over the `n` batch ranks of a value that every rank
    then uses alike. Its backward is the all-reduce of the upstream
    gradients, which are equal on every rank: `n` times the rank's own,
    with no collective (the sharded step averages the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x, groups, n):
        import torch.distributed as dist

        ctx.n = n
        y = x.detach().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """`x` averaged over the batch ranks when a mesh is current and its
    process group is live (each rank then holds its shard of the batch, and
    a mean over tokens must be global); `x` itself otherwise, and for a
    DTensor (whose own mean over the batch was already global)."""
    m = current_mesh()
    if not live(m) or is_dtensor(x):
        return x
    names = [n for n in ("pod", "data") if n in m.axis_names]
    if not names:
        return x
    dm = device_mesh(m)
    n = math.prod(m.shape[a] for a in names)
    return _BatchSum.apply(x, [dm.get_group(a) for a in names], n) / n


def constraint(x, *spec):
    """Identity with no mesh, and on a plain tensor (each rank's tensor is
    already its own part); a DTensor under a mesh is redistributed to the
    resolved spec.

    spec entries: 'batch' -> ('pod','data'); 'data'/'model'/'pod' -> axis if
    present; None -> replicated dim.
    """
    m = current_mesh()
    if m is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    resolved = []
    for n, s in zip(x.shape, spec):
        if s == "batch":
            s = batch_axes()
        elif isinstance(s, str):
            s = axis(s)
        # an axis that does not divide the dim leaves it replicated (the
        # rules' divisibility guard; DTensor would split it unevenly)
        resolved.append(s if s is None or n % _axis_size(m, s) == 0 else None)
    return x.redistribute(x.device_mesh, NamedSharding(m, P(*resolved)).placements(x.ndim))


# ---------------------------------------------------------------------------
# DTensors: serving on a mesh (`serve.sharded`, `launch.dryrun`)
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def dtensor(local: torch.Tensor, sharding: NamedSharding, shape) -> torch.Tensor:
    """The DTensor of global `shape` under `sharding` whose chunk on this
    rank is `local` (the live mesh's `DeviceMesh`)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, device_mesh(sharding.mesh),
                              sharding.placements(len(shape)), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def distribute(t: torch.Tensor, sharding: NamedSharding, rank: int) -> torch.Tensor:
    """A whole tensor held by every rank -> the DTensor whose chunk on
    `rank` is its slice under `sharding` (a view: no communication, no
    copy)."""
    return dtensor(sharding.local(t, rank), sharding, t.shape)


def write_at(t: torch.Tensor, dim: int, start: int, value) -> None:
    """t[..., start:start + n, ...] = value along `dim`, in place (n the
    extent of `value` along `dim`; a number fills to the end of `dim`).

    A plain `t` is written through a view. A DTensor `t` whose `dim` is
    split over mesh axes (a cache's sequence dim) cannot be written through
    a view: DTensor would gather the dim first and write the gathered copy.
    So `value` is laid out as `t` with `dim` replicated (a redistribution
    by hand: a slice of a replicated value moves no bytes) and each rank
    copies the part of the range that falls in its own chunk of `dim`."""
    if not is_dtensor(t):
        if isinstance(value, (int, float)):
            t.narrow(dim, start, t.shape[dim] - start).fill_(value)
        else:
            t.narrow(dim, start, value.shape[dim]).copy_(value)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, places = t.device_mesh, t.placements
    local = t.to_local()
    lo, hi = dim_range(t, dim)
    if isinstance(value, (int, float)):
        a = max(lo, start)
        if a < hi:
            local.narrow(dim, a - lo, hi - a).fill_(value)
        return
    n = value.shape[dim]
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in places]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    v = value.redistribute(mesh, want).to_local()
    a, b = max(lo, start), min(hi, start + n)
    if a < b:
        local.narrow(dim, a - lo, b - a).copy_(v.narrow(dim, a - start, b - a))


def even_split(x, dim: int, parts: int):
    """`x` itself, unless it is a DTensor whose `dim` is split over mesh
    axes whose product does not divide `parts` (the units the dim is about
    to be split into: heads): those axes then replicate the dim."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    places, n, changed = list(x.placements), 1, False
    for i, p in enumerate(places):
        if p.is_shard(dim % x.ndim):
            if parts % (n * x.device_mesh.size(i)):
                places[i], changed = Replicate(), True
            else:
                n *= x.device_mesh.size(i)
    return x.redistribute(x.device_mesh, places) if changed else x


def dim_range(t, dim: int) -> tuple:
    """[lo, hi) of `dim` that this rank's chunk of the DTensor `t` holds:
    split evenly over the mesh axes that shard it, in mesh order."""
    from torch.distributed.tensor import Shard

    coord = t.device_mesh.get_coordinate()
    lo, size = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            if type(p) is not Shard:
                raise ValueError(f"write_at: {p} on dim {dim} is not an even split")
            n = t.device_mesh.size(i)
            size //= n
            lo += coord[i] * size
    return lo, lo + size


# ---------------------------------------------------------------------------
# cache placements (the port of `repro.launch.dryrun.cache_pspec`)
# ---------------------------------------------------------------------------

_STACKED_CACHE = re.compile(r"(^|/)blocks(/|$)")


def cache_pspec(path: str, leaf, long_ctx: bool, mesh: Mesh) -> P:
    """Spec of the cache leaf at `path` (the reference's cache tree: leaves
    under blocks/ carry a leading layer-stack dim) of `leaf`'s shape.
    Decode shards a KV cache's S over 'model' (flash-decoding), and a
    long-context one (B = 1) over data + model; state-space states shard
    their channels over 'model'; a dim its axes do not divide is
    replicated."""
    bat = tuple(n for n in ("pod", "data") if n in mesh.axis_names)
    full = tuple(getattr(leaf, "shape", leaf))
    stacked = bool(_STACKED_CACHE.search(path))
    shape = full[1:] if stacked else full
    nd = len(shape)

    def _p(*spec):
        # a one-name tuple is that name, an empty one None (as
        # `PartitionSpec` normalizes them)
        spec = [s[0] if isinstance(s, tuple) and len(s) == 1 else s or None
                for s in spec]
        fixed = [s if s is None or shape[i] % _axis_size(mesh, s) == 0 else None
                 for i, s in enumerate(spec)]
        return P(*(([None] if stacked else []) + fixed))

    if re.search(r"(^|/)(k|v|cross_k|cross_v)$", path) and nd == 4:
        if long_ctx:
            sp = ("data", "model") if "pod" not in mesh.axis_names \
                else ("pod", "data", "model")
            return _p(None, sp, None, None)
        return _p(bat, "model", None, None)
    if path.endswith("pos") and nd == 1:
        return _p(None)
    if path.endswith("conv") and nd == 3:
        return _p(None if long_ctx else bat, None, "model")
    if path.endswith("ssm") and nd == 3:
        return _p(None if long_ctx else bat, "model", None)
    if path.endswith("wkv") and nd == 4:
        return _p(None if long_ctx else bat, "model", None, None)
    if nd >= 1 and not long_ctx:
        return _p(bat, *([None] * (nd - 1)))
    return _p(*([None] * nd))


def cache_shardings(caches, mesh: Mesh, long_ctx: bool):
    """`cache_pspec` of every leaf of a cache tree, as `NamedSharding`s."""
    from ..core.pytree import map_with_paths

    return map_with_paths(
        lambda path, leaf: NamedSharding(mesh, cache_pspec(path, leaf, long_ctx, mesh)),
        caches)
