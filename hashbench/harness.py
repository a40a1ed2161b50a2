"""The benchmark of the port's hashing path: one cell, one run.

    python hashbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`: the
hash family, K, the Bloom filter's modulus) and a traffic mix
(`traffic/<name>.json`: the pool of batches, the lengths, the calls in
flight, the size of the check). Set-up makes the pool on the card from the
seed, builds `repro_torch.hash.Hasher.from_spec` with the seed, and calls
`probe_indices` on every batch. The window is a closed loop: the caller
calls `probe_indices(tokens, m, lengths)` on the next batch of the pool,
records a CUDA event, and waits on the oldest event only when `in_flight`
are outstanding. Once the window has closed the run compares a sample of
the window's answers, drawn from the seed, with `reference/`, and prints one
JSON line.

With `--trace 1` the profiler records the card's activity alone (its
kernels, copies and the CUDA runtime calls that issue them, not the host's
operators) over the window's last `TRACE_SECONDS`, or its second half where
shorter, emptied of calls in flight at its start and end, so every device
operation in it belongs to a call made in it. The host's time in each call
is read on the host clock in the untraced part before it. The line carries
the cell's per-layer metrics, each read by `metrics/<name>.py` (every
per-layer metric of `BENCHMARK.json` lists its cells), and the breakdown.

A configuration that names a runner (`"runner": "train_step"`) is another
kind of cell: `runners/<runner>.py` runs it under the same arguments and
returns the same result object.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from hashbench import devtrace, generator, roofline
from hashbench.reference import keys as ref_keys
from hashbench.reference import probes as ref_probes

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 2.0
REF_BLOCK_ROWS = 1024  # rows of the reference at a time


def forbidden_modules() -> list:
    """The FORBIDDEN top-level names found in `sys.modules`."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def program():
    """The system under test: (Hasher, HashSpec, engine dispatch count)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.hash import Hasher, HashSpec
    from repro_torch.kernels import launch_count

    return Hasher, HashSpec, launch_count


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict   # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: tuple  # names of the end-to-end metrics the cell reports
    per_layer: tuple   # names of its per-layer metrics
    units: dict        # metric name -> unit


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """Cell `name` of `root/BENCHMARK.json`, with its configuration and
    traffic files read (traffic: `root/hashbench/traffic/<traffic>.json`)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    wl = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "hashbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    e2e = tuple(m["name"] for m in bench["end_to_end"]
                if name in m.get("workloads", [name]))
    per = tuple(m["name"] for m in bench["per_layer"] if name in m["workloads"])
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(name, wl["chips"], config, traffic, e2e, per, units)


def reader(metric: str):
    """The `read(trace, ctx)` function of `metrics/<metric>.py`."""
    path = ROOT / "hashbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"hashbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass(frozen=True)
class Context:
    """What a metric's reader may know of the cell besides the trace."""
    lengths: np.ndarray  # (batches, rows) of the pool
    N: int
    K: int
    enqueue_s: "float | None" = None  # mean host seconds in a call, untraced


class Loop:
    """The closed loop over the pool: `depth` calls in flight, and a
    reservoir of `keep` outputs, uniform over the window's calls and drawn
    from the seed, kept for the check."""

    def __init__(self, call, batches: int, depth: int, keep: int, seed: int,
                 cuda: bool):
        self.call, self.P, self.depth, self.keep = call, batches, depth, keep
        self.events = [torch.cuda.Event() for _ in range(depth)] if cuda else None
        self.inflight = collections.deque()
        self.batches: list = []   # pool batch of each call
        self.enqueue_s = 0.0      # host seconds inside the calls
        self.kept: list = []      # (call, batch, output)
        self.rng = np.random.default_rng([int(seed), 0x4B45])
        self.u = self.rng.random(4096)

    @property
    def calls(self) -> int:
        return len(self.batches)

    def _offer(self, out, b: int) -> None:
        i = self.calls
        if len(self.kept) < self.keep:
            self.kept.append((i, b, out))
            return
        if i % 4096 == 0:
            self.u = self.rng.random(4096)
        r = int(self.u[i % 4096] * (i + 1))
        if r < self.keep:
            self.kept[r] = (i, b, out)

    def step(self) -> None:
        b = self.calls % self.P
        t = time.perf_counter()
        out = self.call(b)
        self.enqueue_s += time.perf_counter() - t
        ev = None
        if self.events is not None:
            ev = self.events[self.calls % self.depth]
            ev.record()
        self.inflight.append(ev)
        self._offer(out, b)
        self.batches.append(b)
        if len(self.inflight) == self.depth:
            self._pop()

    def _pop(self) -> None:
        ev = self.inflight.popleft()
        if ev is not None:
            ev.synchronize()

    def run(self, deadline: float, min_calls: int = 0) -> None:
        """Calls until `deadline` (and at least `min_calls` calls), then
        waits for every call in flight."""
        while time.perf_counter() < deadline or self.calls < min_calls:
            self.step()
        while self.inflight:
            self._pop()


def sample_rows(rng, lengths_b: np.ndarray, rows: int) -> np.ndarray:
    """`rows` rows of a batch drawn from `rng`, its longest row among them."""
    B = len(lengths_b)
    pick = rng.choice(B, size=min(rows, B) - 1, replace=False)
    return np.unique(np.append(pick, int(np.argmax(lengths_b))))


def check(cell: Cell, seed: int, pool, got: list, prog_keys: torch.Tensor,
          device) -> tuple:
    """Hold the sampled answers against the reference.

    got: [(batch, rows, (R, K) answers)]. Returns (checks, failed): each
    compared number with its limit, and the sampled calls with a wrong
    answer."""
    cfg = cell.config
    K, m, fam = cfg["n_hashes"], cfg["modulus"], cfg["family"]
    family = importlib.import_module(f"hashbench.reference.{fam}")
    cols = int(pool.lengths_host.max()) + 2
    keys_np = ref_keys.key_matrix(seed, K, cols)
    keys = torch.from_numpy(keys_np.view(np.int64)).to(device)
    key_diff = int((prog_keys[:, :cols] != keys.cpu()).sum())
    probe_diff, failed = 0, 0
    for b, rows, answers in got:
        wrong = 0
        for r0 in range(0, len(rows), REF_BLOCK_ROWS):
            idx = torch.from_numpy(rows[r0:r0 + REF_BLOCK_ROWS]).to(device)
            lens = pool.lengths[b][idx]
            toks = pool.tokens[b][idx][:, :int(lens.max())]
            want = ref_probes.mod_u64(family.surface(toks, lens, keys), m)
            wrong += int((answers[r0:r0 + REF_BLOCK_ROWS] != want.cpu()).sum())
        probe_diff += wrong
        failed += wrong > 0
    short = cell.traffic["check"]["batches"] - len(got)
    checks = {"probe_mismatches": {"value": probe_diff, "limit": 0},
              "key_mismatches": {"value": key_diff, "limit": 0},
              "batches_short": {"value": short, "limit": 0}}
    return checks, failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, min_calls: int = 0,
             warm_calls: "int | None" = None) -> dict:
    """One run of `cell`; returns the result line's object. A configuration
    that names a runner is run by `runners/<runner>.py`."""
    if "runner" in cell.config:
        runner = importlib.import_module(f"hashbench.runners.{cell.config['runner']}")
        return runner.run(cell, seed, seconds, trace, device, t_start, min_calls)
    Hasher, HashSpec, launch_count = program()
    cfg, tr = cell.config, cell.traffic
    K, m = cfg["n_hashes"], cfg["modulus"]
    if ref_probes.bloom_size(cfg["bloom"]["n_items"], cfg["bloom"]["fp_rate"]) != (m, K):
        raise ValueError(f"{cell.name}: modulus and K are not the Bloom "
                         f"filter's {cfg['bloom']}")
    N, depth = tr["max_tokens"], tr["in_flight"]
    keep, rows = tr["check"]["batches"], tr["check"]["rows"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    marks = {"import": time.perf_counter()}
    pool = generator.make_pool(tr, seed, device)
    sync()
    marks["pool"] = time.perf_counter()
    spec = HashSpec(family=cfg["family"], n_hashes=K, out_bits=64,
                    variable_length=True, seed=int(seed))
    hasher = Hasher.from_spec(spec, max_len=N, device=device)
    marks["keys"] = time.perf_counter()

    def call(b):
        return hasher.probe_indices(pool.tokens[b], m, pool.lengths[b])

    # warm-up: every batch, and as many outputs held at once as the window
    # holds, so the allocator has cached their blocks
    warm = pool.batches + keep + depth if warm_calls is None else warm_calls
    held = [call(i % pool.batches) for i in range(warm)]
    sync()
    del held
    marks["warm"] = time.perf_counter()
    live = [roofline.live_tokens(pool.lengths_host[b], N) for b in range(pool.batches)]
    setup_s = time.perf_counter() - t_start
    phases = ", ".join(f"{k} {v - t:.3f} s" for (k, v), t in
                       zip(marks.items(), [t_start, *marks.values()]))

    loop = Loop(call, pool.batches, depth, keep, seed, cuda)
    launches0 = launch_count()
    wall, prof, marked, window_s = timed_window(
        loop.run, seconds, trace, min_calls, cuda, lambda: (loop.calls, loop.enqueue_s))
    first, enqueued = marked or (0, 0.0)
    enqueue_s = enqueued / first if first else None
    launches = launch_count() - launches0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    # the window has closed: keep the sampled answers, free the program
    rng = np.random.default_rng([int(seed), 0x524F])
    got = []
    for _, b, out in sorted(loop.kept, key=lambda k: k[0]):
        r = sample_rows(rng, pool.lengths_host[b], rows)
        got.append((b, r, out[torch.from_numpy(r).to(device)].cpu()))
    prog_keys = hasher.keys.cpu()
    loop.kept.clear()
    del hasher, call
    loop.call = None

    checks, failed = check(cell, seed, pool, got, prog_keys, device)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    trace_ = ctx = None
    if trace:
        trace_ = devtrace.read(prof, loop.batches[first:], window_s, kind)
        ctx = Context(pool.lengths_host, N, K, enqueue_s)
    gbytes = 4 * sum(live[b] for b in loop.batches) / 1e9
    print(f"{cell.name} seed {seed}: {loop.calls} calls in {wall:.6f} s "
          f"(engine dispatches {launches}); enqueue mean "
          f"{1e6 * loop.enqueue_s / max(1, loop.calls):.3f} us; setup "
          f"{setup_s:.6f} s ({phases}); {kind}", file=sys.stderr)
    return result_line(cell, correct, loop.calls, failed, checks, device, peak,
                       kind, {"hash_GBps": gbytes / wall, "setup_s": setup_s},
                       trace_, ctx)


def timed_window(advance, seconds: float, trace: bool, min_calls: int, cuda: bool,
                 mark=lambda: None) -> tuple:
    """The measured window. `advance(deadline, at_least)` works until the
    deadline has passed and `at_least` calls or steps are made, and returns
    once all it started have ended. Untraced, one stretch of `seconds`;
    traced, the profiler records the card's activity alone over the last
    `TRACE_SECONDS` (or the second half, where shorter), and `mark()` is
    read where it starts. -> (wall seconds, profiler or None, `mark()`'s
    value, the traced window's seconds)."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    prof = marked = window_s = None
    if not trace:
        advance(t0 + seconds, min_calls)
    else:
        traced_s = min(TRACE_SECONDS, seconds / 2)
        advance(t0 + seconds - traced_s, 0)
        marked = mark()
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])
        prof.start()
        tp = time.perf_counter()
        advance(tp + traced_s, min_calls)
        sync()
        window_s = time.perf_counter() - tp
        prof.stop()
    sync()
    return time.perf_counter() - t0, prof, marked, window_s


def result_line(cell: Cell, correct: bool, attempted: int, failed: int, checks: dict,
                device, peak: int, kind: str, values: dict, trace=None,
                ctx=None) -> dict:
    """The result line's object. Untraced, the cell's end-to-end metrics
    found in `values`; traced (`trace`: a `devtrace.Trace`), its per-layer
    metrics, each read by its reader with `ctx`, the device's busy and
    window seconds and the breakdown."""
    cuda = device.type == "cuda"
    units, metrics, extra = cell.units, {}, {}
    if trace is None:
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in cell.end_to_end if k in values}
    else:
        for name in cell.per_layer:
            v = reader(name)(trace, ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        extra = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": kind, "count": 1 if cuda else 0,
                         "memory_peak_bytes": int(peak), **extra}}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, t_start: "float | None" = None, root: Path = ROOT,
         device=None) -> int:
    """Run one cell and print its line. `device` None is the card, which
    must be there; the tests pass the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device(device), t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
