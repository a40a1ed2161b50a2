"""The op census (`repro_torch.launch.op_analysis`) of the port's train
step, prefill and decode on one device against the reference's
`hlo_analysis.totals` of its jitted one-device function (smoke configs).

Prefill and decode agree exactly. A train step differs by exactly the
cross-entropy's label pick, in both counts: the reference selects the
label's logit by a one-hot einsum, a dot of 2 B T V FLOPs in XLA's count
(the backward's product with the one-hot is no dot after XLA's
simplification, the recompute's is dead code), where the port gathers
it; and PyTorch's logsumexp backward recomputes exp(x - lse) over the
(B, T, V) logits, B T V transcendentals that XLA takes from the forward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.launch import hlo_analysis
from repro.models import build as jbuild
from repro.train import Schedule as JSchedule
from repro.train import init_state as jinit_state
from repro.train import make_optimizer as jmake_optimizer
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.launch.op_analysis import Census
from repro_torch.models import build, params_from_jax
from repro_torch.train import Schedule, make_optimizer, make_train_step
from repro_torch.train.train_state import from_reference

B, T, S = 4, 32, 48
ARCHS = ["mistral_nemo_12b", "granite_moe_hash"]


def _batch(cfg, train: bool):
    g = np.random.default_rng(3)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if train:
        batch["labels"] = g.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return batch


def _totals(fn, *args) -> dict:
    return hlo_analysis.totals(jax.jit(fn).lower(*args).compile().as_text())


def _census(fn, *args) -> dict:
    with Census(args) as c:
        fn(*args)
    return c.totals()


@functools.lru_cache(maxsize=None)
def _serving(arch):
    jc, tc = jget(arch, smoke=True), get_config(arch, smoke=True)
    japi, tapi = jbuild(jc), build(tc)
    jp = japi.init(jax.random.key(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, japi, tapi, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_census_equal_hlo_totals(arch):
    jc, japi, tapi, jp, tp = _serving(arch)
    batch = _batch(jc, False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = _totals(lambda p, b: japi.prefill(p, b, cache_len=S), jp, jb)
    with Census() as c:
        _, caches = tapi.prefill(tp, batch, cache_len=S)
    got = c.totals()
    for key in ("dot_flops_per_device", "transcendentals_per_device"):
        assert got[key] == want[key] > 0, key
    _, jcaches = jax.jit(lambda p, b: japi.prefill(p, b, cache_len=S))(jp, jb)
    tok = np.random.default_rng(4).integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
    want = _totals(lambda p, c, t: japi.decode_step(p, c, t, T), jp, jcaches,
                   jnp.asarray(tok))
    got = _census(lambda c, t: tapi.decode_step(tp, c, t, T), caches, tok)
    for key in ("dot_flops_per_device", "transcendentals_per_device"):
        assert got[key] == want[key] > 0, key
    assert got["collectives"] == {} and got["peak_bytes"] >= got["argument_bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_census_equals_hlo_totals_but_the_label_pick(arch):
    jc = jget(arch, smoke=True)
    tc = get_config(arch, smoke=True)
    japi = jbuild(jc)
    jopt = jmake_optimizer(jc.optimizer, JSchedule())
    jstate = jinit_state(japi, jopt, jax.random.key(1))
    batch = _batch(jc, True)
    want = _totals(jmake_train_step(japi, jopt), jstate,
                   {k: jnp.asarray(v) for k, v in batch.items()})
    state = from_reference(tc, jax.tree.map(np.asarray, jstate), device="cpu")
    step = make_train_step(build(tc), make_optimizer(tc.optimizer, Schedule()))
    got = _census(step, state, batch)
    pick = B * T * tc.vocab_size
    assert got["dot_flops_per_device"] + 2 * pick == want["dot_flops_per_device"]
    assert got["transcendentals_per_device"] - pick == want["transcendentals_per_device"]
    assert dataclasses.asdict(tc)["remat"] == dataclasses.asdict(jc)["remat"]
