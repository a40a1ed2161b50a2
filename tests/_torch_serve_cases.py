"""Shared cases of `tests/test_torch_sharded_serve_*.py`: sharded prefill
and decode (`repro_torch.serve.sharded`) on a threaded (data 2, model 2)
world of CPU ranks (`repro_torch.parallel.local_world`) against the
reference's single-device `prefill` and `decode_step`.

Smoke configs in f32, weights drawn by the reference (key 0) and carried
across by `params_from_jax`; each rank holds them at the serving
placements (DTensors), its batch rows at `batch_sharding` (replicated
when B = 1, the long-context layout: the caches' S over data + model).
A prefill of T tokens into caches of S positions, then N_DECODE decode
steps; every rank's gathered logits equal the reference's within TOL (the
decode tolerance of PERF.md). `moe_groups` is the reference dry run's,
gcd(B, batch ranks). Several files, so that `--dist loadfile` spreads
them.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro_torch.configs import get_config
from repro_torch.models import build, params_from_jax
from repro_torch.parallel import Mesh, local_world
from repro_torch.serve import sharded as ss

TOL = 2e-3
# the reference jitted at XLA's backend optimization level 0: the same
# program, compiled in a fraction of the time
REFERENCE_XLA = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}
T, S, N_DECODE = 16, 32, 4
MESH = Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))


def _inputs(cfg, B: int):
    g = np.random.default_rng(7)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.encdec:
        batch["frames"] = g.normal(size=(B, cfg.encoder_positions,
                                         cfg.d_model)).astype(np.float32)
    ticks = [g.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(N_DECODE)]
    return batch, ticks


def reference(name: str, B: int):
    """The reference's f32 prefill logits and N_DECODE decode logits on one
    device, its weights as numpy, the inputs."""
    jc = dataclasses.replace(jget(name, smoke=True), dtype="float32")
    api = jbuild(jc)
    params = api.init(jax.random.key(0))
    groups = math.gcd(B, 2)
    batch, ticks = _inputs(jc, B)
    prefill = jax.jit(lambda p, b: api.prefill(p, b, cache_len=S, moe_groups=groups),
                      compiler_options=REFERENCE_XLA)
    decode = jax.jit(lambda p, c, t, pos: api.decode_step(p, c, t, pos,
                                                          moe_groups=groups),
                     compiler_options=REFERENCE_XLA)
    logits, caches = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    out = [np.asarray(logits)]
    for i, t in enumerate(ticks):
        logits, caches = decode(params, caches, jnp.asarray(t), jnp.int32(T + i))
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, params), batch, ticks


def sharded(name: str, B: int, jparams, batch, ticks):
    """Every rank's gathered logits of the port's sharded prefill and
    decode steps (list a rank of N_DECODE + 1 arrays)."""
    cfg = dataclasses.replace(get_config(name, smoke=True), dtype="float32")
    api = build(cfg)
    params = params_from_jax(cfg, jparams, device="cpu")
    groups = math.gcd(B, 2)
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}

    def rank(r):
        def place(x):
            return ss.replicated(x, MESH) if B == 1 else ss.shard_batch(x, MESH, r)

        p = ss.shard_params(params, MESH, r)
        logits, caches = ss.prefill(api, p, {k: place(v) for k, v in whole.items()},
                                    cache_len=S, moe_groups=groups)
        out = [logits.full_tensor().numpy()]
        for i, t in enumerate(ticks):
            logits, caches = ss.decode_step(api, p, caches, place(torch.from_numpy(t)),
                                            T + i, moe_groups=groups)
            out.append(logits.full_tensor().numpy())
        return out

    return local_world.run(rank, MESH)


def check(name: str, B: int = 4) -> None:
    want, jparams, batch, ticks = reference(name, B)
    for r, got in enumerate(sharded(name, B, jparams, batch, ticks)):
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} B {B} rank {r} step {i}")
