"""One rank's share of the sharded train step's model: the layout
primitives that the models' training forward (`models.transformer`,
`models.encdec` and their sublayers, given a `Partition`) computes its
share with, and the collectives they need, each with its adjoint as its
backward.

What the reference's `jit_train_step` gets from XLA's partitioner under
the rules of `parallel.sharding` (its in/out shardings, the `constraint`
calls at the layer boundaries, the remat'd scan over blocks), written out
per rank on plain tensors with explicit collectives over the live process
group (`parallel.local_world`'s threads, `parallel.fake_world`, or one
process a rank). `WHOLE`, the partition of a world of one rank, makes
every primitive the plain operation: the single-device forward is the
same code.

Layout. Each batch rank holds its rows. At the block boundaries the
residual stream is split along the sequence over "model" when the model
ranks divide its length and `cfg.seq_shard_activations` is on (the
reference's sequence split), else every model rank holds it whole. A
sublayer normalizes its share, gathers the whole sequence (`enter`),
computes on the model rank's share of the weights (`linear`) and returns
its partial sums with a reduce-scatter along the sequence, or an
all-reduce when the stream is whole (`exit`). A weight that the rules do
not split over "model" is used whole; where its sublayer's work cannot
split, the model ranks repeat it.

Weights. A block's chunks are gathered over the batch axes (FSDP) inside
the block's remat'd function (`gather`), in the dtype the models read
them in, so the recompute gathers again and no rank holds more than one
block beyond its chunks; the backward of that gather reduce-scatters the
block's gradient into the rank's chunk at once and sums it over the ranks
that hold the same chunk.

Gradients. Every collective's backward is its adjoint (all-gather and
reduce-scatter, all-reduce and all-reduce), and the model ranks' losses
add up to their batch rank's (each counts the tokens it owns, and the
balance loss once over them). So the gradients summed over the ranks that
hold a chunk are its gradient, whether the work that used it was split or
repeated.

Serving (`ServingPartition`, the rank's part of sharded prefill and
decode, no gradient) adds the layout of the rank's batch rows and of its
cache chunks (`parallel.sharding.cache_pspec`): the span of a KV cache's
positions the rank holds, the axes whose ranks hold the other spans (over
which flash-decoding combines), and gathers and sums over the batch axes.
With one rank, or a training `Partition`, a cache is whole and the rows
are the rank's own.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .sharding import NamedSharding, cache_pspec


def _collectives():
    # imported at use, as `parallel/__init__.py` does: `parallel.collectives`
    # draws on `quality.keygen`, which imports the hashing package
    from . import collectives

    return collectives


class _Gather(torch.autograd.Function):
    """A rank's chunk -> the tensor gathered over `axes` ([(dim, axis)],
    minor axis first) in `dtype`. Backward: the reduce-scatters in the
    other order, in f32, then the sum over `replicas` (the axes whose
    ranks hold the same chunk), in the chunk's dtype."""

    @staticmethod
    def forward(ctx, t, part, axes, replicas, dtype):
        c = _collectives()
        ctx.part, ctx.axes, ctx.replicas, ctx.dtype = part, axes, replicas, t.dtype
        y = t.to(dtype)
        for d, a in axes:
            y = c.all_gather_dim(y, d, part.dm, a, part.traffic)
        return y.clone() if y is t else y

    @staticmethod
    def backward(ctx, g):
        c, part = _collectives(), ctx.part
        g = g.float()
        for d, a in reversed(ctx.axes):
            g = c.reduce_scatter_dim(g, d, part.dm, a, part.traffic)
        if ctx.replicas:
            g = g.clone()
            for a in ctx.replicas:
                c.all_reduce(g, part.dm, a, part.traffic)
        return g.to(ctx.dtype), None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, part):
        ctx.dim, ctx.part = dim, part
        return _collectives().all_gather_dim(x, dim, part.dm, "model", part.traffic)

    @staticmethod
    def backward(ctx, g):
        p = ctx.part
        return (_collectives().reduce_scatter_dim(g, ctx.dim, p.dm, "model", p.traffic),
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, part):
        ctx.dim, ctx.part = dim, part
        return _collectives().reduce_scatter_dim(x, dim, part.dm, "model", part.traffic)

    @staticmethod
    def backward(ctx, g):
        p = ctx.part
        return (_collectives().all_gather_dim(g.contiguous(), ctx.dim, p.dm, "model",
                                              p.traffic), None, None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return _collectives().all_reduce(x.clone(), part.dm, "model", part.traffic)

    @staticmethod
    def backward(ctx, g):
        p = ctx.part
        return _collectives().all_reduce(g.clone(), p.dm, "model", p.traffic), None


class Partition:
    """One rank's view of the partitioned program: `M` model ranks, its
    model coordinate `r`, the gather plan of each of its chunks (`plans`:
    id of the chunk -> (the (dim, axis) it is gathered over, in order; the
    axes whose ranks hold the same chunk; the dtype it is gathered in))
    and the collectives over "model" of the `DeviceMesh` `dm`; the bytes
    it sends go to `traffic`."""

    def __init__(self, M: int = 1, r: int = 0, dm=None, plans: dict | None = None,
                 traffic: dict | None = None):
        self.M, self.r, self.dm = int(M), int(r), dm
        self.plans, self.traffic = plans or {}, traffic

    # -- weights ---------------------------------------------------------
    def gather(self, module):
        """The rank's weights of a `ParamTree` (sub)tree, gathered over the
        batch axes: nested dicts (and lists) as the models read them; the
        tree itself when nothing is gathered."""
        if not self.plans:
            return module
        if isinstance(module, nn.ModuleList):
            return [self.gather(m) for m in module]
        out = {k: self._leaf(t) for k, t in {**module._parameters,
                                             **module._buffers}.items()}
        out.update({k: self.gather(m) for k, m in module._modules.items()})
        return out

    def tops(self, params, names) -> dict:
        """The top-level subtrees `names` of `params` that it has, gathered
        once for the whole forward."""
        return {k: self.gather(params[k]) for k in names if k in params}

    def _leaf(self, t):
        plan = self.plans.get(id(t))
        if plan is None:
            return t
        axes, replicas, dtype = plan
        if not axes and not replicas and dtype == t.dtype:
            return t
        return _Gather.apply(t, self, axes, replicas, dtype)

    # -- the residual stream ---------------------------------------------
    def seq(self, cfg, T: int) -> bool:
        """Whether a stream of length T is split along the sequence."""
        return bool(cfg.seq_shard_activations) and self.M > 1 and T % self.M == 0

    def enter(self, h, sp: bool):
        """A sublayer's normed input -> the whole sequence."""
        return _AllGather.apply(h, 1, self) if sp else h

    def own(self, x, sp: bool):
        """A whole-sequence value every model rank holds -> the stream's
        layout."""
        if not sp:
            return x
        n = x.shape[1] // self.M
        return x.narrow(1, self.r * n, n)

    def exit(self, y, kind: str, bias=None, *, sp: bool):
        """A sublayer's output of `linear`'s kind -> the stream's layout."""
        if kind == "partial":
            if sp:
                y = _ReduceScatter.apply(y, 1, self)
            elif self.M > 1:
                y = _AllReduce.apply(y, self)
            return y if bias is None else y + bias.to(y.dtype)
        if kind == "cols":
            y = self.whole(y)
        return self.own(y, sp)

    # -- features --------------------------------------------------------
    def whole(self, t, dim: int = -1):
        """Every model rank's part of `dim` (an all-gather)."""
        return _AllGather.apply(t, dim % t.ndim, self) if self.M > 1 else t

    def mine(self, t, dim: int = -1):
        """This rank's part of a whole `dim`."""
        n = t.shape[dim] // self.M
        return t.narrow(dim, self.r * n, n)

    def fit(self, t, dim: int, n: int):
        """`t` with `dim` of n elements: as it is, this rank's part of it,
        or the whole of the rank's part."""
        if t.shape[dim] == n:
            return t
        return self.mine(t, dim) if t.shape[dim] > n else self.whole(t, dim)

    def sum(self, t):
        """The sum over "model" of partial sums (an all-reduce)."""
        return _AllReduce.apply(t, self) if self.M > 1 else t

    def max_(self, t):
        """The largest over "model", in place (no gradient)."""
        if self.M > 1:
            import torch.distributed as dist

            _collectives().all_reduce(t, self.dm, "model", self.traffic,
                                      op=dist.ReduceOp.MAX)
        return t

    def owned(self, B: int, T: int, device) -> torch.Tensor:
        """(B, T) f32: 1 where this model rank counts a (row, position)'s
        loss (a slice of the sequence where the ranks divide it)."""
        own = torch.arange(T, device=device) * self.M // T == self.r if T % self.M == 0 \
            else torch.arange(B * T, device=device).reshape(B, T) % self.M == self.r
        return own.float().expand(B, T)

    def linear(self, x, x_cols: bool, p, d_in: int, d_out: int, dtype):
        """x @ w (+ b) with the rank's gathered `w` of the whole (d_in,
        d_out) -> (y, kind, bias): kind "full" (every column), "cols" (the
        rank's columns) or "partial" (the rank's rows: partial sums, whose
        bias is returned, to be added after their sum). `x_cols`: x holds
        the rank's columns of its last dim. With one model rank, the
        models' `layers.linear`."""
        w = p["w"]
        rows = self.M > 1 and w.shape[0] != d_in
        cols = self.M > 1 and w.shape[1] != d_out
        if x_cols and not rows:
            x = self.whole(x)
        elif rows and not x_cols:
            x = self.mine(x)
        y = x @ w.to(dtype)
        b = p["b"] if "b" in p else None
        if rows:
            return y, "partial", b
        if b is not None:
            y = y + (self.mine(b, 0) if cols else b).to(dtype)
        return y, "cols" if cols else "full", None


    # -- batch rows and caches (whole here: `ServingPartition`) -----------
    nb = 1            # the parts the batch axes split the rows into
    cache_len = None  # the positions of a self-attention KV cache

    def all_rows(self, t):
        """Every batch rank's rows of `t` (dim 0), in the batch's order."""
        return t

    def my_rows(self, t):
        """This rank's rows of an `all_rows` tensor."""
        return t

    def reduce(self, t, axes, op=None):
        """The sum (or `op`) over the ranks along `axes` of `t`, in place."""
        return t

    def join(self, t, dim: int, axes):
        """The ranks' chunks of `t` along `dim`, split over `axes` (major
        first), gathered whole."""
        return t

    def span(self, name: str, n: int) -> tuple:
        """(lo, hi, axes): the positions [lo, hi) of a KV cache leaf `name`
        ("k", "cross_k") of n positions that this rank holds, and the mesh
        axes whose ranks hold the others."""
        return 0, n, ()

    def cache_chunk(self, path: str, shape) -> tuple:
        """The global index ranges (a `slice` a dim) of the cache leaf at
        `path` of the global `shape` that this rank holds."""
        return tuple(slice(0, n) for n in shape)


def row_parts(mesh, B: int) -> int:
    """The parts B rows are split into over `mesh`'s batch axes: all of
    them when they divide B (`batch_sharding`), else 1 (every rank holds
    every row)."""
    n = math.prod(n for a, n in mesh.shape.items() if a in ("pod", "data"))
    return n if B % n == 0 else 1


class ServingPartition(Partition):
    """Rank `rank` of `mesh` serving B rows (global) into caches of S
    positions: `Partition`'s model ranks, the gather plans of its weights
    (`plans`: the chunks the serving rules split over the batch axes), and
    the serving layout -- rows split over the batch axes when they divide
    B (else every rank holds them all), caches at `cache_pspec`
    (long-context when B = 1)."""

    def __init__(self, mesh, rank: int, dm, B: int, S: int, plans: dict | None = None,
                 traffic: dict | None = None):
        coords = mesh.coords(rank)
        super().__init__(mesh.shape.get("model", 1), coords.get("model", 0), dm, plans,
                         traffic)
        self.mesh, self.rank, self.coords = mesh, int(rank), coords
        self.batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        self.nb = row_parts(mesh, B)
        self.long_ctx, self.cache_len = B == 1, int(S)

    def all_rows(self, t):
        return t if self.nb == 1 else self.join(t, 0, self.batch_axes)

    def my_rows(self, t):
        if self.nb == 1:
            return t
        i = 0
        for a in self.batch_axes:
            i = i * self.mesh.shape[a] + self.coords[a]
        n = t.shape[0] // self.nb
        return t.narrow(0, i * n, n)

    def reduce(self, t, axes, op=None):
        c = _collectives()
        for a in axes:
            c.all_reduce(t, self.dm, a, self.traffic, op=op)
        return t

    def join(self, t, dim: int, axes):
        c = _collectives()
        for a in reversed(axes):
            t = c.all_gather_dim(t, dim, self.dm, a, self.traffic)
        return t

    def _sharding(self, path: str, shape):
        return NamedSharding(self.mesh, cache_pspec(path, tuple(shape), self.long_ctx,
                                                    self.mesh))

    def span(self, name: str, n: int) -> tuple:
        s = self._sharding(name, (1, n, 1, 1))
        axes = s._dim_axes(4)[1]
        rows = s.chunk((1, n, 1, 1), self.rank)[1]
        return rows.start, rows.stop, axes

    def cache_chunk(self, path: str, shape) -> tuple:
        return self._sharding(path, shape).chunk(tuple(shape), self.rank)


WHOLE = Partition()
