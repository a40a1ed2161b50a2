"""The port's trainer (`repro_torch.train.Trainer`) on the CPU: the
reference's `tests/test_trainer_e2e.py` and `tests/test_system.py` cases,
and checkpoints exchanged with the reference's trainer both ways.

A training checkpoint holds the state in the reference's layout (blocks
stacked, key planes u32, the reference's leaf paths, shapes and dtypes),
so either package resumes the other's. The interchange runs in f32
(`mistral_nemo_12b` SMOKE, `dtype="float32"`) and holds the port's state
after 3 steps from a reference checkpoint against the reference's own 3
steps from it with `_torch_port.train_states_close` (parameters within
2 x the summed learning rates + 1e-5, at most FLIPS elements past 1e-5;
the optimizer's state within 1e-3 of its leaf's largest magnitude).
"""
import dataclasses
import json
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import train_states_close
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.train import Schedule as JSchedule
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_state as jinit_state
from repro.train import make_optimizer as jmake_optimizer
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.data import HashPipeline, PipelineConfig
from repro_torch.data.synthetic import corpus
from repro_torch.models import build
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import SimulatedFault, Trainer, TrainerConfig

CFG = get_config("mistral_nemo_12b", smoke=True)
F32 = "float32"
FLIPS = 64


def _batches(vocab, B=4, T=16, seed=0):
    pipe = HashPipeline(PipelineConfig(seq_len=T, batch_size=B, eval_pct=0,
                                       dedup=False), device="cpu")
    while True:
        yield from pipe.pack(corpus(seed=seed, n_docs=10_000, vocab=vocab,
                                    dup_rate=0.0))


def _cfg(**kw):
    return TrainerConfig(**{"log_every": 1, **kw})


def test_loss_decreases(tmp_path):
    api = build(CFG)
    tc = _cfg(total_steps=30, checkpoint_every=100, checkpoint_dir=str(tmp_path),
              peak_lr=5e-3, warmup_steps=5)
    tr = Trainer(api, tc, device="cpu")
    tr.train(_batches(CFG.vocab_size))
    losses = [m["loss"] for m in tr.metrics_log]
    assert all(isinstance(v, float) for m in tr.metrics_log
               for k, v in m.items() if k != "step")
    assert losses[-1] < losses[0] * 0.9, losses


def test_fault_recovery_resumes_from_checkpoint(tmp_path):
    api = build(CFG)
    tc = _cfg(total_steps=20, checkpoint_every=5, checkpoint_dir=str(tmp_path),
              peak_lr=1e-3, warmup_steps=2)
    tr = Trainer(api, tc, device="cpu")
    fired = {"n": 0}

    def injector(step):
        if step == 12 and fired["n"] == 0:
            fired["n"] += 1
            raise SimulatedFault("preempted")

    state = tr.train(_batches(CFG.vocab_size), fault_injector=injector)
    assert fired["n"] == 1
    assert tr.restarts >= 1
    assert int(state.step) == 20  # completed despite the fault
    # the replay started from the step-10 checkpoint: steps 10 and 11 twice
    assert [m["step"] for m in tr.metrics_log].count(10) == 2


def test_resume_is_deterministic(tmp_path):
    """Same data + same checkpoint => identical params after resume."""
    api = build(CFG)
    tc = _cfg(total_steps=10, checkpoint_every=5, log_every=100,
              checkpoint_dir=str(tmp_path), peak_lr=1e-3, warmup_steps=2)
    s1 = Trainer(api, tc, device="cpu").train(_batches(CFG.vocab_size, seed=3))
    # a second trainer resumes from the saved step-10 checkpoint; with 0
    # more steps to do it must return the restored state exactly
    tc2 = _cfg(total_steps=10, checkpoint_every=5, log_every=100,
               checkpoint_dir=str(tmp_path))
    s2 = Trainer(api, tc2, device="cpu").train(_batches(CFG.vocab_size, seed=3))
    for a, b in zip(s1.params.parameters(), s2.params.parameters()):
        assert torch.equal(a, b)


def test_replay_after_a_fault_is_deterministic(tmp_path):
    """A fault makes the trainer redo steps from its last checkpoint: the
    end state equals an uninterrupted run's, bit for bit."""
    api = build(CFG)
    runs = []
    for fault in (False, True):
        tc = _cfg(total_steps=6, checkpoint_every=2,
                  checkpoint_dir=str(tmp_path / str(fault)), peak_lr=1e-3,
                  warmup_steps=1)
        fired = []

        def injector(step):
            if fault and step == 3 and not fired:
                fired.append(step)
                raise SimulatedFault("preempted")

        data = list(_take(_batches(CFG.vocab_size, seed=5), 6))
        # the faulted step draws data[3] and drops it; the replay from the
        # step-2 checkpoint draws data[2:] again
        order = iter(data[:4] + data[2:] if fault else data)
        runs.append(Trainer(api, tc, device="cpu").train(order, injector))
    for a, b in zip(runs[0].params.parameters(), runs[1].params.parameters()):
        assert torch.equal(a, b)


def _take(it, n):
    for _ in range(n):
        yield next(it)


def test_straggler_watchdog(tmp_path):
    api = build(CFG)
    tc = TrainerConfig(total_steps=1, checkpoint_dir=str(tmp_path), deadline_factor=2.0,
                       max_stragglers=1)
    tr = Trainer(api, tc, device="cpu")
    for _ in range(10):
        assert not tr._watchdog(1.0)
    assert tr._watchdog(5.0)  # 5x median trips the deadline
    assert tr._straggler_strikes == 1
    assert not tr._watchdog(1.0)
    assert tr._straggler_strikes == 0


def test_default_checkpoint_dir_is_under_the_temporary_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert TrainerConfig().checkpoint_dir == str(tmp_path / "repro_ckpt")


def test_trainer_runs_on_the_card_by_default(tmp_path):
    tc = TrainerConfig(total_steps=1, checkpoint_dir=str(tmp_path))
    if torch.cuda.is_available():
        assert Trainer(build(CFG), tc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(build(CFG), tc)


# ---------------------------------------------------------------------------
# checkpoints exchanged with the reference's trainer
# ---------------------------------------------------------------------------

def _both(name="mistral_nemo_12b"):
    return (dataclasses.replace(jget(name, smoke=True), dtype=F32),
            dataclasses.replace(get_config(name, smoke=True), dtype=F32))


def _fixed_batches(cfg, n=8):
    return list(_take(_batches(cfg.vocab_size, seed=7), n))


def _jax_iter(batches):
    return iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches])


def _manifest(d, step):
    with open(d / f"step_{step}" / "manifest.json") as f:
        return json.load(f)["leaves"]


@pytest.mark.parametrize("name", ["mistral_nemo_12b", "granite_moe_hash"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, name):
    """The reference takes 3 steps and checkpoints; from that checkpoint
    the reference's `Trainer` and the port's each train 3 more steps on
    the same batches, and reach the same state. granite_moe_hash carries
    the hash router's u32 key planes through the checkpoint. The first 3
    steps run the reference's jitted `make_train_step` and its
    `Checkpointer`: its `Trainer` cannot start such a model afresh (its
    AdamW state holds the parameters' own key-plane arrays, which its
    donating jit then donates twice); resumed from a checkpoint, the
    arrays are distinct and it trains."""
    jc, tc = _both(name)
    batches = _fixed_batches(tc)
    lr = dict(peak_lr=1e-3, warmup_steps=0)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    japi = jbuild(jc)
    opt = jmake_optimizer(jc.optimizer, JSchedule(decay_steps=6, **lr))
    state, step = jinit_state(japi, opt, jax.random.key(0)), jax.jit(
        jmake_train_step(japi, opt))
    for b in _jax_iter(batches[:3]):
        state, _ = step(state, b)
    JCheckpointer(str(ref_dir)).save(3, state)
    shutil.copytree(ref_dir, port_dir)
    jtr = JTrainer(jbuild(jc), JTrainerConfig(total_steps=6, checkpoint_every=3,
                                              checkpoint_dir=str(ref_dir),
                                              log_every=1, **lr))
    jstate = jtr.train(_jax_iter(batches))
    ttr = Trainer(build(tc), _cfg(total_steps=6, checkpoint_every=3,
                                  checkpoint_dir=str(port_dir), **lr), device="cpu")
    tstate = ttr.train(iter(batches))
    assert ttr.restarts == jtr.restarts == 1
    for jm, tm in zip(jtr.metrics_log, ttr.metrics_log):
        assert jm["step"] == tm["step"]
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    lr_sum = sum(m["lr"] for m in jtr.metrics_log)
    flips = train_states_close(jax.tree.map(np.asarray, jstate), tstate, lr_sum)
    assert flips <= FLIPS, flips
    # both final checkpoints have the same leaves, shapes and dtypes
    jm, tm = _manifest(ref_dir, 6), _manifest(port_dir, 6)
    assert set(jm) == set(tm)
    for path in jm:
        assert (jm[path]["shape"], jm[path]["dtype"]) == \
               (tm[path]["shape"], tm[path]["dtype"]), path


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port trains and checkpoints; the reference's `Checkpointer`
    verifies it and restores every leaf equal to the port's state."""
    jc, tc = _both("granite_moe_hash")
    tr = Trainer(build(tc), _cfg(total_steps=2, checkpoint_every=2,
                                 checkpoint_dir=str(tmp_path)), device="cpu")
    state = tr.train(iter(_fixed_batches(tc)))
    japi = jbuild(jc)
    like = jinit_state(japi, jmake_optimizer(jc.optimizer, JSchedule()),
                       jax.random.key(0))
    ck = JCheckpointer(str(tmp_path))
    assert ck.latest_valid() == 2
    restored = ck.restore(2, like)
    assert int(restored.step) == 2
    assert train_states_close(jax.tree.map(np.asarray, restored), state, 0.0,
                              state_rtol=0.0) == 0


# ---------------------------------------------------------------------------
# the reference's tests/test_system.py on the port
# ---------------------------------------------------------------------------

def test_full_system_path(tmp_path):
    cfg = CFG
    api = build(cfg)

    # 1. data: dedup + split + pack through the paper's hash families
    pipe = HashPipeline(PipelineConfig(seq_len=16, batch_size=4, eval_pct=2,
                                       dedup=True), device="cpu")
    batches = []
    for b in pipe.pack(corpus(seed=11, n_docs=3000, vocab=cfg.vocab_size,
                              dup_rate=0.1)):
        batches.append(b)
        if len(batches) >= 64:
            break
    # routing stats need a larger sample than the 64 packed batches consume
    for doc in corpus(seed=99, n_docs=400, vocab=cfg.vocab_size, dup_rate=0.15):
        pipe.admit(doc)
    assert pipe.stats["dup"] > 0
    assert pipe.stats["eval"] > 0

    # 2. train with periodic verified checkpoints
    tc = TrainerConfig(total_steps=12, checkpoint_every=6, log_every=4,
                       checkpoint_dir=str(tmp_path), peak_lr=2e-3,
                       warmup_steps=3)
    tr = Trainer(api, tc, device="cpu")
    state = tr.train(iter(batches * 4))
    assert int(state.step) == 12
    assert tr.ckpt.latest_valid() == 12
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)

    # 3. serve from the trained params
    eng = ServeEngine(api, state.params, n_slots=2, max_seq=48, device="cpu")
    reqs = [Request(i, np.arange(6, dtype=np.int32) + i, max_new_tokens=4)
            for i in range(3)]
    eng.submit_all(reqs)
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
