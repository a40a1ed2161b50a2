"""Shared cases of the `tests/test_torch_train_*.py` files, one file a
family (so that `--dist loadfile` spreads them over the workers): the
port's gradients and train step (`repro_torch.train`) against the
reference's `jax.value_and_grad` and `make_train_step`, on the CPU.

One SMOKE config of each family, in f32 (`dtype="float32"`), with the
reference's weights carried across as f32 masters (`params_from_jax(...,
train=True)`; the whole train state by `train_state.from_reference`). The
same seeded numpy batch goes to both. The reference's gradients at its
first state and its three steps come from one jitted call a step
(`reference_steps`, cached), shared by a family's gradient and step
tests: its XLA compile is most of each test's time. Tolerances:
- the loss: rel 1e-5;
- every gradient leaf: max |port - reference| <= GRAD_RTOL x the leaf's
  largest magnitude + 1e-7. GRAD_RTOL is 1e-5, and 3e-5 for jamba, whose
  Mamba scans combine in another order (the reference's
  `associative_scan` against the port's doubling scan): its worst leaf
  measured 1.3e-5. The 1e-7 covers gradients that are 0 in exact
  arithmetic and ~1e-10 in both packages (whisper's key biases: the
  softmax is blind to them);
- three whole steps (lr 1e-3, no warmup): after AdamW's first step every
  element moves by about lr x sign(g), so an element whose gradient is
  within rounding of 0 may step the other way in one package: a
  difference of up to 2 lr a step. Parameters are held within
  2 x (the sum of the three learning rates) + 1e-5 everywhere, and the
  count of elements past 1e-5 (such flips) is at most FLIPS of the whole
  tree; the optimizer's state within 1e-3 of its leaf's largest
  magnitude + 1e-9 (the moments of gradients that are 0 in exact
  arithmetic are noise of ~1e-11); each step's metrics within rel 1e-4.
  With int8 compression in the step, a gradient that differs by rounding
  can round to the neighbouring int8 code (one code is the leaf's
  absmax / 127, 0.8% of its largest gradient) on a few elements, so the
  metrics are held within rel 1e-3 and the optimizer's state within 2e-2
  of its leaf's largest magnitude.
- bf16 (`mistral_nemo_12b` only; the routed families flip routes on near
  ties in bf16): the loss within rel 2e-3 and each gradient leaf within
  BF16_GRAD of its largest magnitude. The packages round to bf16 in
  different places (XLA after each op, PyTorch inside fused ones), and
  the reference's gathers from the hashed tables accumulate in bf16, the
  port's in f32 (`layers.hashed_embed`).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import train_states_close
from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.train import Schedule as JSchedule
from repro.train import init_state as jinit_state
from repro.train import make_optimizer as jmake_optimizer
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tget
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.models import build as tbuild
from repro_torch.models import params_from_jax
from repro_torch.parallel import Mesh, batch_sharding, local_world
from repro_torch.train import Schedule, jit_train_step, make_optimizer, make_train_step
from repro_torch.train.step import reference_grads
from repro_torch.train.train_state import copy_to, from_reference, shard, to_reference

FAMILIES = ["mistral_nemo_12b", "gemma3_27b_hashed", "granite_moe_1b_a400m",
            "granite_moe_hash", "llama4_maverick_400b_a17b", "rwkv6_1_6b",
            "jamba_v0_1_52b", "qwen2_vl_72b", "whisper_large_v3"]
GRAD_RTOL = {"jamba_v0_1_52b": 3e-5}
LR = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
FLIPS = 64
BF16_GRAD = 2e-2
B, T = 2, 16


def rng(seed):
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def configs(name, dtype="float32"):
    return (dataclasses.replace(jget(name, smoke=True), dtype=dtype),
            dataclasses.replace(tget(name, smoke=True), dtype=dtype))


def make_batch(cfg, seed, b=B) -> dict:
    g = rng(seed)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (b, T)).astype(np.int32),
             "labels": g.integers(0, cfg.vocab_size, (b, T)).astype(np.int32)}
    if cfg.encdec:
        batch["frames"] = g.normal(
            size=(b, cfg.encoder_positions, cfg.d_model)).astype(np.float32)
    if cfg.vision_prefix:
        batch["patch_embeds"] = g.normal(
            size=(b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return batch


def on_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def ref_grads(api, params, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss(p, batch), has_aux=True, allow_int=True))(params)
    flat = flatten_with_paths(jax.tree.map(np.asarray, grads))
    return loss, {p: g for p, g in flat if g.dtype.kind == "f"}


def assert_grads_close(got: dict, want: dict, rtol: float):
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].detach().numpy()
        assert g.shape == w.shape, path
        w = w.astype(np.float32)
        err = np.abs(g - w).max()
        assert err <= rtol * np.abs(w).max() + 1e-7, (path, err, np.abs(w).max())


def weights(jc, tc, seed=1, train=True):
    jparams = jbuild(jc).init(jax.random.key(seed))
    return jparams, params_from_jax(tc, jax.tree.map(np.asarray, jparams),
                                    device="cpu", train=train)


@functools.lru_cache(maxsize=None)
def reference_steps(name, n_steps=3, **kw):
    """n_steps of the reference's jitted make_train_step(**kw) from its
    init_state (key 1) on seeded batches. Without kw the same jitted call
    also gives `jax.value_and_grad` of the loss at the step's state (XLA
    computes the shared forward and backward once). -> (the first state as
    numpy, the batches, the first loss and {path: gradient} or None, the
    metrics of each step, the last state as numpy)."""
    jc, _ = configs(name)
    japi = jbuild(jc)
    jopt = jmake_optimizer(jc.optimizer, JSchedule(**LR))
    jstate = jinit_state(japi, jopt, jax.random.key(1))
    jstep = jmake_train_step(japi, jopt, **kw)

    def grads_and_step(state, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: japi.loss(p, batch), has_aux=True, allow_int=True)(state.params)
        return (loss, grads), jstep(state, batch)

    run = jax.jit(jstep if kw else grads_and_step)
    first = jax.tree.map(np.asarray, jstate)
    batches, metrics, loss, grads = [], [], None, None
    for s in range(n_steps):
        batch = make_batch(jc, 10 + s, b=2 * B if kw.get("grad_accum") else B)
        out = run(jstate, on_jax(batch))
        if not kw:
            (l, g), out = out
            if s == 0:
                loss, grads = float(l), {p: x for p, x in flatten_with_paths(
                    jax.tree.map(np.asarray, g)) if x.dtype.kind == "f"}
        jstate, jm = out
        batches.append(batch)
        metrics.append(jm)
    return first, batches, loss, grads, metrics, jax.tree.map(np.asarray, jstate)


def run_steps(name, **kw):
    """The reference's steps (`reference_steps`) and the port's from the
    same state on the same batches -> (reference state, port state,
    [(reference metrics, port metrics)])."""
    _, tc = configs(name)
    first, batches, _, _, jmetrics, jstate = reference_steps(name, **kw)
    topt = make_optimizer(tc.optimizer, Schedule(**LR))
    tstate = from_reference(tc, first, device="cpu")
    tstep = make_train_step(tbuild(tc), topt, **kw)
    metrics = []
    for batch, jm in zip(batches, jmetrics):
        tstate, tm = tstep(tstate, batch)
        metrics.append((jm, tm))
    return jstate, tstate, metrics


def assert_steps_close(jstate, tstate, metrics, metric_rtol=1e-4, state_rtol=1e-3):
    for jm, tm in metrics:
        assert set(tm) == set(jm) == {"ce", "balance", "loss", "grad_norm", "lr"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=metric_rtol,
                                       atol=1e-6, err_msg=k)
    lrs = sum(float(jm["lr"]) for jm, _ in metrics)
    assert int(tstate.step) == int(jstate.step) == len(metrics)
    flips = train_states_close(jstate, tstate, lrs,
                               state_rtol)
    print(f"parameter elements past 1e-5: {flips}")
    assert flips <= FLIPS, flips


def check_loss_and_grads(name):
    _, tc = configs(name)
    init, batches, jl, jg, _, _ = reference_steps(name)
    tparams = from_reference(tc, init, device="cpu").params
    tl, tg = reference_grads(tbuild(tc), tparams, batches[0])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(tg, jg, GRAD_RTOL.get(name, 1e-5))


def check_bf16_grads():
    jc, tc = configs("mistral_nemo_12b", "bfloat16")
    japi, tapi = jbuild(jc), tbuild(tc)
    jparams, tparams = weights(jc, tc)
    batch = make_batch(jc, 0)
    jl, jg = ref_grads(japi, jparams, on_jax(batch))
    tl, tg = reference_grads(tapi, tparams, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)
    assert_grads_close(tg, jg, BF16_GRAD)


def check_remat_gives_equal_grads():
    """`cfg.remat` recomputes each block in the backward: the same
    gradients, bit for bit, for the LM blocks and whisper's layers."""
    for name in ("granite_moe_hash", "whisper_large_v3"):
        _, tc = configs(name)
        batch = make_batch(tc, 2)
        grads = []
        for remat in (False, True):
            cfg = dataclasses.replace(tc, remat=remat)
            params = tbuild(cfg).init(torch.Generator().manual_seed(3), train=True)
            grads.append(reference_grads(tbuild(cfg), params, batch))
        (l0, g0), (l1, g1) = grads
        assert torch.equal(l0, l1)
        for path in g0:
            assert torch.equal(g0[path], g1[path]), (name, path)


def check_three_steps(name, **kw):
    assert_steps_close(*run_steps(name, **kw))


def check_sharded_steps(name, dims, axes=("data", "model"), metric_rtol=1e-4,
                        state_rtol=1e-3, **kw):
    """The sharded train step (`jit_train_step`) of the same three steps as
    `reference_steps(name, **kw)`, on a world of threaded CPU ranks shaped
    `dims` over `axes`, each rank from its chunks of the same state on its
    rows of the same batches: each step's metrics on every rank, and every
    rank's chunks after the last step against the same chunks of the
    reference's state, within `assert_steps_close`'s bounds. The
    reference's run is the one the family's other tests compile
    (`reference_steps` is cached). The flips are not counted on leaves
    whose first gradient is 0 in exact arithmetic (within the gradient
    tests' 1e-7 at the reference: whisper's key biases, ~1e-10): a split
    of the sums gives their noise other signs."""
    _, tc = configs(name)
    first, batches, _, grads, jmetrics, jstate = reference_steps(name, **kw)
    noise = frozenset(f".params/{p}" for p, g in (grads or {}).items()
                      if np.abs(g).max(initial=0.0) <= 1e-7)
    state = from_reference(tc, first, device="cpu")
    want = from_reference(tc, jstate, device="cpu")
    mesh = Mesh((torch.device("cpu"),) * int(np.prod(dims)), axes, dims)
    step = make_train_step(tbuild(tc), make_optimizer(tc.optimizer, Schedule(**LR)), **kw)
    sharded = jit_train_step(step, mesh, state, {k: v.ndim for k, v in batches[0].items()})

    def rank(r):
        local, metrics = shard(state, mesh, r), []
        for b in batches:
            local, m = sharded(local, {k: batch_sharding(mesh, v.ndim).local(
                torch.from_numpy(v), r) for k, v in b.items()})
            metrics.append(m)
        return copy_to(local, "cpu"), metrics, to_reference(shard(want, mesh, r))

    lrs = sum(float(jm["lr"]) for jm in jmetrics)
    for local, metrics, chunks in local_world.run(rank, mesh):
        for jm, m in zip(jmetrics, metrics):
            for k in jm:
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=metric_rtol,
                                           atol=1e-6, err_msg=k)
        assert int(local.step) == len(batches)
        flips = train_states_close(chunks, local, lrs, state_rtol, noise)
        assert flips <= FLIPS, flips


def check_compress_pod_grads():
    """int8 compression in the step, with the reference's bits (its
    original Threefry layout). mistral has no integer leaves: the
    reference's compression raises on a key plane's float0 gradient."""
    with jax.threefry_partitionable(False):
        assert_steps_close(*run_steps("mistral_nemo_12b", compress_pod_grads=True),
                           metric_rtol=1e-3, state_rtol=2e-2)


def check_sharded_compress_pod_grads():
    """`check_compress_pod_grads`'s steps on a (pod 2, data 1, model 2)
    world: each rank quantizes its chunks of the whole averaged gradient
    with the whole leaf's scale (a max over every rank) and its slice of
    the whole leaf's random bits."""
    with jax.threefry_partitionable(False):
        check_sharded_steps("mistral_nemo_12b", (2, 1, 2), ("pod", "data", "model"),
                            metric_rtol=1e-3, state_rtol=2e-2, compress_pod_grads=True)
