"""One run of a training cell: the port's train step over packed batches.

The configuration file names the port's architecture (`arch`), every
width under its published key, the port's settings (router, capacity
factor, remat, compute dtype, MoE groups) and the optimizer and schedule;
the traffic file (kind `packed`) the pool of batches (`lm_batches.py`).

Set-up makes the pool on the card from the seed and the weights
(`reference.lm.draw`, one normal draw on the card), builds the program
through its normal path (`configs.get_config`, `models.build`,
`models.convert.params_from_jax` with f32 masters, `train.optimizer.adamw`,
`train.step.make_train_step`), and drives that one state through its
first `CHECKED_STEPS` steps, each on the next batch of the pool: the
window's own call and feed. It keeps, on the host, each step's loss, each
leaf's first gradient as the optimizer got it (from its first moment
after one step) and each leaf's change of the parameters after the
checked steps. The window then goes on from the same state: a closed
loop of one step at a time on the next batch, the host enqueuing a step
while the card runs the one before, until `seconds` have passed and the
last step has ended.

`train_tokens_per_s` counts the rows x seq_len tokens of every step of the
window over its wall time; `train_mfu` the steps' model FLOPs
(`flops.py`) over that time and the card's bf16 peak, in %. With `--trace
1` the profiler covers the window's last `harness.TRACE_SECONDS` (whole
steps), and the per-layer metrics are read from it.

Once the window has closed and the peak memory is read, the program is
freed and `reference.lm.Trainer` (f32, TF32 off) takes the same checked
steps from the same draw and batches. `correct`: each number compared
(`checks`) is at most its limit (the configuration's `limits`). A leaf is
a layer's row of a stacked leaf; the moving leaves are those whose
reference first gradient has at least a thousandth of the median leaf's
norm (a leaf with none moves by round-off alone):

- loss_gap: the largest |loss - reference's| / reference's over the
  checked steps;
- grad_norm_gap: the largest over the leaves of |norm - reference's norm|
  of the first gradient, over the larger of the reference's norm of that
  leaf and of the median leaf;
- mean_grad_gap: the mean over the leaves of the same gap;
- grad_cos_gap: the largest over the moving leaves of 1 - cos of the
  angle between the first gradient and the reference's: a gradient in
  the wrong direction, or moved between the experts of one leaf (as far
  as the two hold enough of the leaf: an expert alone is no leaf, since
  one that few tokens reach turns with bf16's routing);
- update_norm_gap: grad_norm_gap's measure of the change after the
  checked steps, over the moving leaves;
- update_cos_gap: grad_cos_gap's of the change: an update applied in the
  wrong direction.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys
import time

import torch

from hashbench import devtrace, flops, harness, lm_batches
from hashbench.harness import ROOT
from hashbench.reference import lm

CHECKED_STEPS = 3
#: the port's `ArchConfig` field of each key of the configuration file
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "num_local_experts": "n_experts", "num_experts_per_tok": "experts_per_token",
               "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings", "router": "router",
               "capacity_factor": "capacity_factor", "remat": "remat", "dtype": "dtype"}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, x in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


class Program:
    """The system under test: the port's train state and step at the
    configuration, from the benchmark's weights."""

    def __init__(self, cfg: dict, weights: dict, device):
        src = str(ROOT / "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        from repro_torch.configs import get_config
        from repro_torch.core.pytree import flatten_with_paths
        from repro_torch.models import build
        from repro_torch.models.convert import params_from_jax, reference_leaves
        from repro_torch.train.optimizer import Schedule, adamw
        from repro_torch.train.step import make_train_step
        from repro_torch.train.train_state import TrainState

        arch = dataclasses.replace(
            get_config(cfg["arch"]), d_head=cfg["hidden_size"] // cfg["num_attention_heads"],
            **{field: cfg[key] for key, field in PORT_FIELDS.items()})
        opt = adamw(Schedule(**cfg["schedule"]), **cfg["optimizer"])
        params = params_from_jax(arch, _nest(weights), device, train=True)
        self.state = TrainState(torch.zeros((), dtype=torch.int32), params,
                                opt.init(params))
        self.step_fn = make_train_step(build(arch), opt, moe_groups=cfg["moe_groups"])
        self.b1 = cfg["optimizer"]["b1"]
        self._flatten, self._leaves = flatten_with_paths, reference_leaves

    def step(self, batch: dict) -> torch.Tensor:
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss"]

    def leaves(self) -> dict:
        out = {}
        for leaf in self._leaves(self.state.params):
            if leaf.stacked:
                out.update((f"{leaf.path}[{i}]", t.detach())
                           for i, t in enumerate(leaf.tensors))
            else:
                out[leaf.path] = leaf.tensors[0].detach()
        return out

    def first_grads(self) -> dict:
        m = dict(self._flatten(self.state.opt_state["m"]))
        return {n: t / (1 - self.b1) for n, t in lm.per_leaf(m).items()}


def open_program(cfg: dict, weights: dict, device):
    """The object the run trains: the program (the control puts the
    reference in its place)."""
    return Program(cfg, weights, device)


def checked_steps(trainer, pool, a, seed: int, device, keep) -> dict:
    """Drive `trainer` through the checked steps; -> the readings compared:
    the losses (floats), each leaf's first gradient and its change after
    the steps ({leaf: f32 tensor} on `keep`)."""
    losses, grads = [], None
    for i in range(CHECKED_STEPS):
        losses.append(trainer.step(pool.batch(i)))
        if i == 0:
            grads = {n: t.to(keep) for n, t in trainer.first_grads().items()}
    before = lm.per_leaf(lm.draw(a, seed, device))
    moved = {n: (t - before[n]).to(keep) for n, t in trainer.leaves().items()}
    del before
    return {"losses": torch.stack(losses).tolist(), "grads": grads, "moved": moved}


def norm_gaps(got: dict, want: dict, names) -> dict:
    """{leaf: relative gap of the norms} over `names`: |got - want| over the
    larger of want and the median leaf's want (inf where got is not a
    number)."""
    floor = statistics.median(want.values())
    return {n: abs(got[n] - want[n]) / max(want[n], floor, 1e-30)
            if math.isfinite(got[n]) else float("inf") for n in names}


def cos_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """1 - cos of the angle between two tensors, as half the squared
    distance of their unit vectors (no cancellation), in f64; 1 where
    either is zero, inf where got is not finite."""
    g, w = got.double(), want.double()
    gn, wn = g.norm(), w.norm()
    if not torch.isfinite(gn):
        return float("inf")
    if gn == 0 or wn == 0:
        return 1.0
    return float((g / gn - w / wn).square().sum() / 2)


def readings(got: dict, want: dict) -> tuple:
    """Each leaf's norms on both sides and its cos_gap, one leaf at a time
    on `want`'s device. -> ({leaf: got's norm}, {leaf: want's}, {leaf: gap})."""
    gn, wn, cos = {}, {}, {}
    for n, w in want.items():
        g = got[n].to(w.device)
        gn[n], wn[n], cos[n] = float(g.norm()), float(w.norm()), cos_gap(g, w)
    return gn, wn, cos


def compare(cfg: dict, got: dict, want: dict) -> tuple:
    """-> (checks, the worst leaf of each leaf-wise number)."""
    if set(got["grads"]) != set(want["grads"]) or set(got["moved"]) != set(want["moved"]):
        bad = {k: {"value": float("inf"), "limit": v} for k, v in cfg["limits"].items()}
        return bad, {"leaves differ": sorted(set(got["grads"]) ^ set(want["grads"]))[:4]}
    loss = max((abs(g - w) / abs(w) if math.isfinite(g) else float("inf"))
               for g, w in zip(got["losses"], want["losses"]))
    g_got, g_want, g_cos = readings(got["grads"], want["grads"])
    m_got, m_want, m_cos = readings(got["moved"], want["moved"])
    floor = statistics.median(g_want.values())
    moving = [n for n, g in g_want.items() if g >= 1e-3 * floor]
    grad = norm_gaps(g_got, g_want, g_want)
    moved = norm_gaps(m_got, m_want, moving)
    grad_cos = {n: g_cos[n] for n in moving}
    moved_cos = {n: m_cos[n] for n in moving}
    worst = lambda d: max(d, key=d.get)  # noqa: E731
    values = {"loss_gap": loss, "grad_norm_gap": grad[worst(grad)],
              "mean_grad_gap": statistics.fmean(grad.values()),
              "grad_cos_gap": grad_cos[worst(grad_cos)],
              "update_norm_gap": moved[worst(moved)],
              "update_cos_gap": moved_cos[worst(moved_cos)]}
    checks = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in values.items()}
    return checks, {"gradient": worst(grad), "gradient's angle": worst(grad_cos),
                    "update": worst(moved), "update's angle": worst(moved_cos),
                    "left out": len(grad) - len(moving)}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        min_calls: int = 0) -> dict:
    cfg, tr = cell.config, cell.traffic
    a = lm.Arch.of(cfg)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    marks = {"import": time.perf_counter()}
    pool = lm_batches.make_pool(tr, a.V, seed, device)
    weights = lm.draw(a, seed, device)
    sync()
    marks["draw"] = time.perf_counter()
    prog = open_program(cfg, weights, device)
    del weights
    sync()
    marks["build"] = time.perf_counter()
    got = checked_steps(prog, pool, a, seed, device, "cpu")
    marks["checked_steps"] = time.perf_counter()
    setup_s = time.perf_counter() - t_start
    phases = ", ".join(f"{k} {v - t:.3f} s" for (k, v), t in
                       zip(marks.items(), [t_start, *marks.values()]))

    batches: list = []  # pool batch of each step of the window

    def steps_until(deadline: float, at_least: int) -> None:
        """Steps on the next batches until `deadline` and `at_least` steps,
        one in flight behind the one enqueued; returns once all ended."""
        prev, n = None, 0
        while time.perf_counter() < deadline or n < at_least:
            b = (CHECKED_STEPS + len(batches)) % pool.batches
            prog.step(pool.batch(b))
            batches.append(b)
            n += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    prev.synchronize()
                prev = ev
        sync()

    wall, prof, first, window_s = harness.timed_window(
        steps_until, seconds, trace, max(1, min_calls), cuda, lambda: len(batches))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    # the window has closed: free the program, then the reference
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = lm.Trainer(a, lm.draw(a, seed, device), cfg["optimizer"], cfg["schedule"])
    want = checked_steps(ref, pool, a, seed, device, device)
    del ref
    ref_s = time.perf_counter() - t_ref
    checks, worst = compare(cfg, got, want)
    cmp_s = time.perf_counter() - t_ref - ref_s
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    values = {"train_tokens_per_s": len(batches) * tr["rows"] * tr["seq_len"] / wall,
              "setup_s": setup_s}
    top = flops.BF16_FLOPS_PER_S.get(kind)  # none for a card it does not hold
    if top is not None:
        done = len(batches) * flops.step_flops(cfg, tr["rows"], tr["seq_len"]) / wall
        values["train_mfu"] = 100 * done / top
    trace_ = devtrace.read(prof, batches[first:], window_s, kind) if trace else None
    print(f"{cell.name} seed {seed}: {len(batches)} steps in {wall:.6f} s; setup "
          f"{setup_s:.6f} s ({phases}); losses {got['losses']} against "
          f"{want['losses']}; worst leaves: {worst}; reference {ref_s:.3f} s, "
          f"comparison {cmp_s:.3f} s; {kind}", file=sys.stderr)
    return harness.result_line(cell, correct, len(batches), int(not correct), checks,
                               device, peak, kind, values, trace_)
