"""Shared helpers of `tests/test_torch_dryrun_*.py`: the reference's dry
run (`repro.launch.dryrun`) read in-process, and the reference's shard
arithmetic of a cell's arguments from its specs.

Importing `repro.launch.dryrun` sets XLA_FLAGS to 512 host devices
(`dryrun.py:2`); in a worker whose JAX has not started, every later test
would then see 512 CPU devices. `reference_dryrun` starts JAX first and
restores the variable. The reference's rules read only `axis_names` and
`devices.shape` of a mesh (`StandIn`); its `NamedSharding`s need a real
mesh of 256 or 512 devices, so its spec trees are read with
`NamedSharding` replaced by the spec it holds.
"""
import contextlib
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.parallel import sharding as jsh

PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names, self.devices = names, np.empty(shape)
        self.shape = dict(zip(names, shape))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@functools.lru_cache(maxsize=None)
def reference_dryrun():
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as rd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return rd


@contextlib.contextmanager
def specs_only(monkeypatch, rd):
    """NamedSharding(mesh, spec) -> spec, in the reference's modules."""
    with monkeypatch.context() as m:
        m.setattr(rd, "NamedSharding", lambda mesh, spec: spec)
        m.setattr(jax.sharding, "NamedSharding", lambda mesh, spec: spec)
        yield


def shard_bytes(spec, shape, dtype, axes: dict) -> int:
    """Bytes of one shard of a `shape` leaf under `spec` (dims split by
    the product of their axes' extents)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for d, e in zip(shape, spec):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= d // math.prod(axes[a] for a in names)
    return n * np.dtype(dtype).itemsize


def _tree_bytes(specs, structs, axes) -> int:
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=is_p)
    flat_x = jax.tree_util.tree_leaves(structs)
    assert len(flat_s) == len(flat_x)
    return sum(shard_bytes(s, x.shape, x.dtype, axes) for s, x in zip(flat_s, flat_x))


@functools.lru_cache(maxsize=None)
def reference_params(arch: str):
    return jax.eval_shape(jbuild(jget(arch)).init, jax.random.key(0))


def reference_argument_bytes(monkeypatch, arch: str, shape_name: str, mesh_kind: str) -> int:
    """The sum over the reference cell's arguments (`build_cell`) of their
    shard shapes x itemsize under its in_shardings."""
    from repro.train.optimizer import Schedule, make_optimizer
    from repro.train.train_state import TrainState, state_shardings

    rd = reference_dryrun()
    dims, names = PRODUCTION[mesh_kind]
    mesh, axes = StandIn(dims, names), dict(zip(names, dims))
    cfg, shape = jget(arch), JSHAPES[shape_name]
    api = jbuild(cfg)
    bat = tuple(n for n in ("pod", "data") if n in names)
    params_s = reference_params(arch)
    batch_spec = lambda n: jax.sharding.PartitionSpec(bat, *([None] * (n - 1)))  # noqa: E731
    total = 0
    with specs_only(monkeypatch, rd), jsh.use_mesh(mesh):
        if shape.kind == "train":
            opt = make_optimizer(cfg.optimizer, Schedule())
            state_s = TrainState(jax.ShapeDtypeStruct((), jnp.int32), params_s,
                                 jax.eval_shape(opt.init, params_s))
            total += _tree_bytes(state_shardings(state_s, mesh, cfg.fsdp_pods),
                                 state_s, axes)
        else:
            serving = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                s.shape, jnp.bfloat16 if s.dtype == jnp.float32 else s.dtype), params_s)
            total += _tree_bytes(jsh.param_specs(serving, serving=True), serving, axes)
        batch_s = api.input_specs(shape)
        if shape.kind != "decode":
            return total + sum(shard_bytes(batch_spec(len(s.shape)), s.shape, s.dtype, axes)
                               for s in jax.tree_util.tree_leaves(batch_s))
        B = shape.global_batch
        long_ctx = B == 1
        caches_s = reference_caches(arch, shape_name)
        total += _tree_bytes(rd.cache_shardings(caches_s, mesh, long_ctx), caches_s, axes)
        tok = jax.sharding.PartitionSpec(None, None) if long_ctx else batch_spec(2)
        return total + shard_bytes(tok, (B, 1), np.int32, axes) + 4


@functools.lru_cache(maxsize=None)
def reference_caches(arch: str, shape_name: str):
    """The reference's decode caches (`build_cell`'s `caches_s`)."""
    cfg, shape = jget(arch), JSHAPES[shape_name]
    api = jbuild(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.encdec:
        params_s = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.bfloat16 if s.dtype == jnp.float32 else s.dtype),
            reference_params(arch))
        pre = {"frames": jax.ShapeDtypeStruct((B, cfg.encoder_positions, cfg.d_model),
                                              jnp.bfloat16),
               "tokens": jax.ShapeDtypeStruct((B, 8), jnp.int32)}
        return jax.eval_shape(lambda p, b: api.prefill(p, b, cache_len=S), params_s, pre)[1]
    return jax.eval_shape(lambda: api.init_caches(B, S))


def cells(kinds) -> list:
    """(arch, shape, mesh) of every production cell of these shape kinds
    that the reference does not skip."""
    from repro_torch.configs import ARCH_IDS

    return [(a, s, m) for a in ARCH_IDS for s, spec in JSHAPES.items()
            if spec.kind in kinds and s not in jget(a).skip_shapes for m in PRODUCTION]
