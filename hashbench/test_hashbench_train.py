"""The training cell on the CPU: the reference against the port, the FLOP
count by hand, the packed batches, whole runs of a tiny cell through
`harness.run_cell`, and the control and each fault seen as not correct.

The tiny cell is the real configuration at granite_moe_smoke's widths
with the port in f32: the limits are set from the chip's readings at the
published widths in bf16, whose gaps a width of 64 does not reproduce."""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from hashbench import flops, harness, lm_batches, model_faults
from hashbench.generator import quantile_lengths
from hashbench.reference import lm
from hashbench.runners import train_step

ROOT = Path(__file__).resolve().parents[1]
CELL = "granite_moe_1b_a400m.train"
SMOKE = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 64, "num_local_experts": 8,
         "num_experts_per_tok": 4, "vocab_size": 499}
TINY_TRAFFIC = {"batches": 4, "rows": 2, "seq_len": 32}
SEED = 3_000_000_029


def tiny_cell(**config) -> harness.Cell:
    cell = harness.load_cell(CELL)
    return dataclasses.replace(cell, config=dict(cell.config, **SMOKE, dtype="float32",
                                                 **config),
                               traffic=dict(cell.traffic, **TINY_TRAFFIC))


@pytest.mark.parametrize("seed", [7, 3_000_000_019, 2**40 + 5])
def test_reference_matches_port(seed, cpu):
    """Loss, every leaf's gradient and one AdamW update of the reference
    against the port's f32 train step, on the same seeded draw (the
    capacity rule drops pairs at this size: 64 tokens, k 4 of 8 experts)."""
    from repro_torch.train.step import reference_grads

    cell = tiny_cell()
    cfg, a = cell.config, lm.Arch.of(cell.config)
    batch = lm_batches.make_pool(cell.traffic, a.V, seed, cpu).batch(0)
    prog = train_step.Program(cfg, lm.draw(a, seed, cpu), cpu)
    ref = lm.Trainer(a, lm.draw(a, seed, cpu), cfg["optimizer"], cfg["schedule"])

    with lm.no_tf32():
        want_loss, _ = lm.loss(a, ref.W, batch["tokens"], batch["labels"], ref.mm)
        want = torch.autograd.grad(want_loss, list(ref.W.values()))
    got_loss, got = reference_grads(prog.step_fn.api, prog.state.params, batch)
    torch.testing.assert_close(got_loss, want_loss.detach(), rtol=1e-6, atol=0)
    for path, g in zip(ref.W, want):
        torch.testing.assert_close(got[path], g, rtol=1e-4, atol=1e-7, msg=path)

    # one step: the schedule's rate is 0 at step 0, so step twice
    for i in range(2):
        torch.testing.assert_close(prog.step(batch), ref.step(batch), rtol=1e-6, atol=0)
    got, want = prog.leaves(), ref.leaves()
    assert set(got) == set(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-8, msg=name)


def test_attention_in_blocks_of_rows(monkeypatch):
    """The reference's scores a block of query rows at a time give the
    values of the whole (T, T) product: blocks of 5 rows against 1."""
    a = lm.Arch.of(tiny_cell().config)
    w = {p[len(lm.PREFIX):]: t[0] for p, t in lm.draw(a, 11, "cpu").items()
         if p.startswith(lm.PREFIX)}
    h = torch.randn(2, 32, a.D, generator=torch.Generator().manual_seed(4))
    whole = lm.attention(a, w, h, torch.matmul)
    monkeypatch.setattr(lm, "Q_ROWS", 5)
    torch.testing.assert_close(lm.attention(a, w, h, torch.matmul), whole,
                               rtol=1e-6, atol=1e-6)


def test_cos_gap():
    """1 - cos: 0 for one direction, 2 for the opposite, 1 against zero,
    inf for a gradient that is not finite; small angles keep their digits."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    assert train_step.cos_gap(x, 3 * x) < 1e-15
    assert train_step.cos_gap(-x, x) == pytest.approx(2)
    assert train_step.cos_gap(torch.zeros(1000), x) == 1.0
    assert train_step.cos_gap(x * float("nan"), x) == float("inf")
    y = x.clone()
    y[0] += 1e-3  # 1 - cos = (1 - (x0 y0 ... ) ~ |d_perp|^2 / 2 |x|^2
    perp = torch.zeros(1000)
    perp[0] = 1e-3
    perp -= (perp @ x) / (x @ x) * x
    assert train_step.cos_gap(y, x) == pytest.approx(
        float(perp.double().square().sum() / 2 / x.double().square().sum()), rel=1e-3)


def test_flops_by_hand():
    cell = tiny_cell()
    # per layer: q, o 64 x 64, k, v 64 x 32; router 64 x 8; 4 experts x 3 x 64 x 64
    per_layer = 2 * 64 * 64 + 2 * 64 * 32 + 64 * 8 + 4 * 3 * 64 * 64
    assert flops.active_params(cell.config) == 2 * per_layer + 64 * 499 == 155_840
    # a token: 6 a parameter, plus 6 x 2 layers x 4 heads x 16 x 32 positions
    assert flops.step_flops(cell.config, 2, 32) == 64 * (6 * 155_840 + 6 * 2 * 4 * 16 * 32)
    full = harness.load_cell(CELL).config
    assert flops.active_params(full) == 428_608_512
    assert flops.step_flops(full, 8, 1024) == 22_303_916_163_072
    # the cell's step: 4 rows of 4,096, the attention term 4 x as long a token
    per_token = 6 * 428_608_512 + 6 * 24 * 16 * 64 * 4096
    assert flops.step_flops(full, 4, 4096) == 16_384 * per_token == 52_029_535_813_632
    assert flops.BF16_FLOPS_PER_S == {"NVIDIA H100 80GB HBM3": 989.4e12}


def test_packed_batches(cpu):
    """Every seed: the same documents, in its own order; EOS after each;
    labels the next token; ids below the vocabulary."""
    traffic = dict(harness.load_cell(CELL).traffic, **TINY_TRAFFIC)
    V, eos = 499, traffic["eos_id"]
    lens = lm_batches.doc_lengths(traffic)
    fewer = quantile_lengths(traffic["lengths"], len(lens) - 1)
    assert int((lens + 1).sum()) >= 4 * 2 * 33 > int((fewer + 1).sum())
    pools = [lm_batches.make_pool(traffic, V, s, cpu) for s in (1, 2, 1)]
    assert torch.equal(pools[0].tokens, pools[2].tokens)
    assert not torch.equal(pools[0].tokens, pools[1].tokens)
    for p in pools:
        assert p.tokens.shape == p.labels.shape == (4, 2, 32) and p.docs == len(lens)
        assert torch.equal(p.tokens[..., 1:], p.labels[..., :-1])
        assert int(p.tokens.min()) >= 0 and int(p.tokens.max()) < V
        stream = torch.cat([p.tokens, p.labels[..., -1:]], dim=-1).reshape(-1)
        assert int((stream == eos).sum()) >= int((torch.cumsum(lens + 1, 0) <= 264).sum())
    with pytest.raises(ValueError, match="packed"):
        lm_batches.make_pool(dict(traffic, kind="docs"), V, 1, cpu)


def test_run_line(cpu):
    res = harness.run_cell(tiny_cell(), SEED, 0.3, False, cpu, time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    # the CPU has no bf16 peak in the table: no share of it is made up
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert set(res["checks"]) == {"loss_gap", "grad_norm_gap", "mean_grad_gap",
                                  "grad_cos_gap", "update_norm_gap", "update_cos_gap"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    json.dumps(res)


def test_traced_line(cpu):
    res = harness.run_cell(tiny_cell(), SEED, 0.2, True, cpu, time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "checks"]
    assert res["correct"] and {"busy_s", "window_s"} <= set(res["device"])
    assert res["metrics"] == {}  # no device operations on the CPU to read


@pytest.mark.parametrize("kind", model_faults.KINDS)
def test_control_and_faults_fail(kind, cpu):
    """The timed path broken underneath the harness: `correct` is false."""
    with model_faults.plant(kind):
        res = harness.run_cell(tiny_cell(), SEED, 0, False, cpu, time.perf_counter())
    assert not res["correct"] and res["failed"] == 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_cells_and_their_metrics():
    """The hashing cells keep exactly their metrics; the training cell has
    its own."""
    for name in ("ml_bloom1e8.docs", "gf_bloom1e8.docs", "ml_bloom1e8.keys"):
        cell = harness.load_cell(name)
        assert cell.end_to_end == ("hash_GBps", "setup_s") and "runner" not in cell.config
    cell = harness.load_cell(CELL)
    assert cell.end_to_end == ("train_tokens_per_s", "train_mfu", "setup_s")
    assert cell.per_layer == ("ops_per_step", "step_idle")
    assert cell.config["runner"] == "train_step" and cell.config["reduced"] == []


CHECK = """
import sys
sys.path[0] = '.'
import torch
from hashbench.reference import lm
a = lm.Arch(2, 32, 4, 2, 16, 4, 2, 97, 1e4, 1e-6, 1.25, 0.01, 1e-4)
tr = lm.Trainer(a, lm.draw(a, 5, 'cpu'), dict(b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1, clip_norm=1.0), dict(peak_lr=3e-4, warmup_steps=100,
                decay_steps=10000, min_ratio=0.1), precision='fp8')
tr.step({'tokens': torch.zeros(2, 8, dtype=torch.int32),
         'labels': torch.ones(2, 8, dtype=torch.int32)})
print(sorted({m.split('.')[0] for m in sys.modules}))
"""


def test_reference_loads_no_program():
    """The reference trains alone: no program, no JAX in its process."""
    p = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
