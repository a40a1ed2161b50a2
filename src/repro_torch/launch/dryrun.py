"""Multi-pod dry run: every (arch x shape) on the production meshes, as the
program of one rank over a fake world, counted by the op census.

The port of `repro.launch.dryrun`. The reference lowers and compiles each
cell over 512 fake host devices and reads XLA's memory and cost analyses
and the HLO text. The port runs the cell's own sharded program -- the
sharded train step (`train.jit_train_step`, ZeRO-3) or sharded prefill and
decode (`serve.sharded`, DTensors at the serving placements) -- as rank 0
of a fake process group of 256 or 512 ranks (`parallel.fake_world`), on
tensors of `FakeTensorMode` (shapes, no storage), under the census
(`launch.op_analysis`). The numbers are the cost of that program per rank,
not XLA's.

Run one cell:   python -m repro_torch.launch.dryrun --arch yi_34b \\
                    --shape train_4k --mesh single --out results/
Run everything: python -m repro_torch.launch.dryrun --all [--mesh both]

Each cell writes results/<arch>__<shape>__<mesh>.json as it ends, so a
sweep resumes (an existing file is skipped); a cell of `cfg.skip_shapes`
writes a `skipped` record, a cell that raises an `error` record, and any
error makes the exit code 1. `--device` is the type of the fake tensors
and of the mesh (default "cuda": the card's program; "cpu" here). The
reference's `--save-hlo` has no counterpart (there is no HLO); `--save-ops`
writes the per-op census beside the cell (<cell>.ops.json: calls, FLOPs,
transcendentals and bytes of each op).

The JSON keeps the keys `benchmarks/roofline.py` reads, with these
meanings:
  - memory.argument_bytes: the bytes of the rank's local chunks of every
    argument (state and batch; weights, caches, token and position);
  - memory.temp_bytes: the census's peak live bytes less the arguments; a
    donated state or cache is updated in place, so it counts once (the
    reference donates them for the same reason);
  - memory.output_bytes: the rank's chunks of the results that are not
    arguments updated in place;
  - cost.flops == corrected.dot_flops_per_device, by construction (the
    census counts each op once: nothing to correct); cost.bytes_accessed
    is the census's sum of every op's reads and writes (no fusion);
  - collectives: the reference's schema (count and per-device result
    bytes of each of the five kinds, total_bytes, total_count), plus
    `traffic`, the bytes the rank sends;
  - trace_s takes the place of lower_s and compile_s: the seconds the
    rank's program took to run on fake tensors.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
import time

import torch

from ..configs import SHAPES, ShapeSpec, get_config, list_configs
from ..models import build
from ..models.encdec import decoder_cache_shapes
from ..models.transformer import compute_dtype, init_caches, place_caches
from ..parallel import sharding as sh
from ..parallel.sharding import cache_pspec, cache_shardings  # noqa: F401  (the reference's names)
from ..serve import sharded as ss
from ..train.optimizer import Schedule, make_optimizer
from ..train.step import jit_train_step, make_train_step
from ..train.train_state import TrainState, map_params, shard
from . import op_analysis
from .mesh import make_production_mesh

COLLECTIVES = op_analysis.COLLECTIVES


def collective_bytes(census: "op_analysis.Census") -> dict:
    """The reference's `collective_bytes` schema from a census: per kind
    {count, bytes} (per-device result bytes), total_bytes, total_count;
    and `traffic` (bytes sent) per kind and in all."""
    out = {c: {"count": census.coll[c]["count"], "bytes": census.coll[c]["bytes"],
               "traffic": census.coll[c]["traffic"]} for c in COLLECTIVES}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    out["total_count"] = sum(v["count"] for k, v in out.items() if k in COLLECTIVES)
    out["traffic"] = sum(v["traffic"] for k, v in out.items() if k in COLLECTIVES)
    return out


def moe_groups_of(shape: ShapeSpec, mesh) -> int:
    """The reference's `moe_groups` of a cell (`dryrun.py:146-148`)."""
    data_par = math.prod(n for a, n in mesh.shape.items() if a != "model")
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else 1)
    return math.gcd(tokens, data_par)


def _batch_placement(mesh, shape) -> "sh.NamedSharding":
    """`batch_sharding`, or replicated when the batch ranks do not divide
    the rows (a long-context batch of one)."""
    if shape[0] % _batch_ranks(mesh):
        return sh.NamedSharding(mesh, sh.P())
    return sh.batch_sharding(mesh, len(shape))


def _batch_local(specs: dict, mesh, device, vocab: int) -> dict:
    """The rank's chunk of each batch entry (name -> (shape, dtype)) at
    `batch_sharding`, as plain tensors (the train step's input)."""
    out = {}
    for name, (shape, dtype) in specs.items():
        local = _batch_placement(mesh, shape).local_shape(shape)
        out[name] = (torch.randint(0, vocab, local, dtype=dtype, device=device)
                     if not dtype.is_floating_point else
                     torch.ones(local, dtype=dtype, device=device))
    return out


def _batch_dtensors(specs: dict, mesh, device, vocab: int) -> dict:
    """The batch as DTensors at `batch_sharding` (the serving input)."""
    local = _batch_local(specs, mesh, device, vocab)
    return {name: sh.dtensor(local[name], _batch_placement(mesh, shape), shape)
            for name, (shape, _) in specs.items()}


def build_cell(arch: str, shape: ShapeSpec, mesh, *, device, cfg=None, rank: int = 0,
               batch_specs: dict | None = None):
    """-> (fn, args, extra): fn(*args) is the program of rank `rank` of
    the cell; args its arguments (the rank's chunks). Call inside the fake
    world of `mesh` (rank 0) under `FakeTensorMode`, or as that rank of a
    live world. `cfg` overrides the architecture's config (a cut-down one
    for checks), `batch_specs` a train cell's batch (name -> (shape,
    dtype); default `api.input_specs`). Serving weights are held in the
    compute dtype (bf16 for every production config, as the reference
    casts them)."""
    cfg = cfg or get_config(arch)
    api = build(cfg)
    groups = moe_groups_of(shape, mesh)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        optimizer = make_optimizer(cfg.optimizer, Schedule())
        step = make_train_step(api, optimizer, moe_groups=groups)
        params = api.init(torch.Generator(device=device), train=True)
        state = TrainState(torch.zeros((), dtype=torch.int32), params,
                           optimizer.init(params))
        local = shard(state, mesh, rank, cfg.fsdp_pods)
        specs = batch_specs or api.input_specs(shape)
        sharded = jit_train_step(step, mesh, state, {k: len(s) for k, (s, _) in
                                                     specs.items()}, cfg.fsdp_pods)
        del state, params
        with _real():  # the step is host arithmetic (the schedule): a real 0-d
            local = local._replace(step=torch.zeros((), dtype=torch.int32))
        batch = _batch_local(specs, mesh, device, cfg.vocab_size)
        return sharded, (local, batch), {"moe_groups": groups}
    # the weights' shapes (no rank materializes the whole model)
    params = ss.local_params(_meta_params(cfg), mesh, dtype=compute_dtype(cfg),
                             device=device)
    if shape.kind == "prefill":
        batch = _batch_dtensors(api.input_specs(shape), mesh, device, cfg.vocab_size)

        def prefill(params, batch):
            return ss.prefill(api, params, batch, cache_len=T, moe_groups=groups)

        return prefill, (params, batch), {"moe_groups": groups}
    long_ctx = B == 1
    # the caches at their placements, each rank making its chunk (the
    # encoder-decoder's cross K/V too, which its prefill would compute:
    # their values do not change what a decode step runs)
    caches = place_caches(cache_shapes(cfg, B, T), device, mesh, long_ctx)
    token = _batch_dtensors({"token": ((B, 1), torch.int32)}, mesh, device,
                            cfg.vocab_size)["token"]
    # the position: a 0-d int32 argument as the reference's; the step takes
    # its value, the last slot of the cache, as a Python int
    pos = torch.zeros((), dtype=torch.int32, device=device)

    def decode(params, caches, token, _pos):
        return ss.decode_step(api, params, caches, token, T - 1, moe_groups=groups)

    return decode, (params, caches, token, pos), {"moe_groups": groups,
                                                  "long_ctx": long_ctx}


def cache_shapes(cfg, B: int, S: int) -> dict:
    """A decode cell's cache tree as meta tensors: the decoder-only
    models' `init_caches`, the encoder-decoder's `decoder_cache_shapes`."""
    dtype = compute_dtype(cfg)
    if cfg.encdec:
        return decoder_cache_shapes(cfg, B, S, dtype)
    with sh.use_mesh(None):
        return init_caches(cfg, B, S, dtype, torch.device("meta"))


def _local_bytes(sharding, shape, dtype) -> int:
    return math.prod(sharding.local_shape(tuple(shape))) * torch.empty(
        (), dtype=dtype, device="meta").element_size()


def argument_bytes(cfg, shape: ShapeSpec, mesh, batch_specs: dict | None = None) -> int:
    """The bytes of the rank's chunks of a cell's arguments, from shapes
    alone (fake tensors): what the dry run's census counts as the
    arguments of `build_cell`'s program, without running it."""
    from ..core.pytree import flatten_with_paths
    from ..train.train_state import state_shardings

    api = build(cfg)
    B, T = shape.global_batch, shape.seq_len
    total = 0
    if shape.kind == "train":
        state = _fake_state(cfg)
        leaves = dict(flatten_with_paths(state))
        for path, s in flatten_with_paths(state_shardings(state, mesh, cfg.fsdp_pods)):
            blocks = leaves[path] if isinstance(s, list) else [leaves[path]]
            for sp, b in zip(s if isinstance(s, list) else [s], blocks):
                total += _local_bytes(sp, b.shape, b.dtype)
        for _, (shp, dt) in (batch_specs or api.input_specs(shape)).items():
            total += _local_bytes(_batch_placement(mesh, shp), shp, dt)
        return total
    params = _meta_params(cfg)
    dtype = compute_dtype(cfg)
    leaves = dict(sh.tree_paths(params))
    for path, s in ss.serving_shardings(params, mesh).items():
        x = leaves[path]
        one = x[0] if isinstance(x, list) else x
        total += _local_bytes(s, sh._shape(x),
                              dtype if one.is_floating_point() else one.dtype)
    if shape.kind == "prefill":
        for _, (shp, dt) in api.input_specs(shape).items():
            total += _local_bytes(_batch_placement(mesh, shp), shp, dt)
        return total
    long_ctx = B == 1
    caches = cache_shapes(cfg, B, T)
    places = dict(flatten_with_paths(sh.cache_shardings(caches, mesh, long_ctx)))
    for path, t in flatten_with_paths(caches):
        total += _local_bytes(places[path], t.shape, t.dtype)
    # the token, and the position (a 0-d int32)
    return total + _local_bytes(_batch_placement(mesh, (B, 1)), (B, 1), torch.int32) + 4


@functools.lru_cache(maxsize=4)
def _meta_params(cfg):
    """The serving weights of `cfg` on the meta device (shapes only),
    drawn as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = build(cfg).init(torch.Generator())
    with _real():  # real meta tensors, whatever fake mode the caller is in
        return map_params(fake, lambda _leaf, t: torch.empty(t.shape, dtype=t.dtype,
                                                             device="meta"))


@functools.lru_cache(maxsize=4)
def _fake_state(cfg):
    """The train state of `cfg` (f32 masters and the optimizer's state) as
    fake tensors, in the reference's layout (`train_state.skeleton`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..train.train_state import skeleton

    with FakeTensorMode(allow_non_fake_inputs=True):
        opt = make_optimizer(cfg.optimizer, Schedule())
        params = build(cfg).init(torch.Generator(), train=True)
        return skeleton(TrainState(torch.zeros((), dtype=torch.int32), params,
                                   opt.init(params)))


def _real():
    """Make real tensors here even under `FakeTensorMode`."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    return unset_fake_temporarily()


def _batch_ranks(mesh) -> int:
    return math.prod(n for a, n in mesh.shape.items() if a in ("pod", "data"))


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in op_analysis.local_tensors(tree)}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str | None = None,
             *, device="cuda", save_ops: bool = False, mesh=None,
             shape: ShapeSpec | None = None, cfg=None, fake: bool = True,
             batch_specs: dict | None = None) -> dict:
    """One cell -> its record (module docstring). `mesh`, `shape`, `cfg`
    and `batch_specs` override the production mesh of `mesh_kind`,
    `SHAPES[shape_name]`, the architecture's config and a train cell's
    batch. With `fake` False the cell runs on real tensors as this rank of
    the live process group (a census of a real run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..parallel.fake_world import fake_world

    t0 = time.time()
    cfg_full = cfg or get_config(arch)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=device)
    if shape_name in cfg_full.skip_shapes and shape is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": "per-DESIGN.md §6"}
    shape = shape or SHAPES[shape_name]
    dev = mesh.devices[0]
    if fake:
        world, rank = fake_world(mesh), 0
    else:
        import torch.distributed as dist

        world, rank = sh.use_mesh(mesh), dist.get_rank()
    with world, op_analysis.dtensor_planning(), \
            (FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()):
        fn, args, extra = build_cell(arch, shape, mesh, device=dev, cfg=cfg, rank=rank,
                                     batch_specs=batch_specs)
        t1 = time.time()
        with op_analysis.Census(args) as census:
            out = fn(*args)
        trace_s = time.time() - t1
        held = _storages(args)
        out_bytes = sum(op_analysis._nbytes(t) for t in op_analysis.local_tensors(out)
                        if t.untyped_storage()._cdata not in held)
        del out, args, fn
    totals = census.totals()
    coll = collective_bytes(census)
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_kind,
        "status": "ok",
        "n_devices": int(mesh.size),
        "device": dev.type,
        "build_s": round(t1 - t0, 1),
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": totals["argument_bytes"],
            "output_bytes": int(out_bytes),
            "temp_bytes": totals["peak_bytes"] - totals["argument_bytes"],
            "peak_bytes": totals["peak_bytes"],
        },
        "cost": {
            "flops": totals["dot_flops_per_device"],
            "bytes_accessed": totals["bytes_accessed"],
            "transcendentals": totals["transcendentals_per_device"],
        },
        "collectives": coll,
        "corrected": totals,
        **extra,
    }
    if save_ops and out_dir is not None:
        with open(f"{out_dir}/{arch}__{shape.name}__{mesh_kind}.ops.json", "w") as f:
            json.dump(census.ops(), f, indent=1)
    print(f"[dryrun] {arch} x {shape.name} x {mesh_kind}: trace {trace_s:.1f}s "
          f"temp/rank {result['memory']['temp_bytes'] / 2**30:.2f} GiB "
          f"args/rank {result['memory']['argument_bytes'] / 2**30:.2f} GiB "
          f"flops/rank {result['cost']['flops']:.3g} "
          f"coll {coll['total_bytes'] / 2**20:.1f} MiB "
          f"(sent {coll['traffic'] / 2**20:.1f} MiB)", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-ops", action="store_true",
                    help="write the per-op census beside each cell")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and of the mesh")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a table and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = ([(a, s) for a in list_configs() for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    if args.jobs > 1:
        return _in_processes(cells, meshes, args)
    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            out_path = f"{args.out}/{arch}__{shape}__{mk}.json"
            if os.path.exists(out_path):
                print(f"[dryrun] skip existing {out_path}")
                continue
            try:
                res = run_cell(arch, shape, mk, args.out, device=args.device,
                               save_ops=args.save_ops)
            except Exception as e:  # noqa: BLE001 -- record, continue sweep
                failures += 1
                res = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                print(f"[dryrun] FAIL {arch} x {shape} x {mk}: {res['error']}",
                      file=sys.stderr)
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1)
    return 1 if failures else 0


def _in_processes(cells, meshes, args) -> int:
    """Each cell in a process of its own, `args.jobs` at a time (a cell's
    trace is single-threaded host work): the exit code 1 if any failed."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    def one(cell):
        (arch, shape), mk = cell
        return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                               "--arch", arch, "--shape", shape, "--mesh", mk,
                               "--out", args.out, "--device", args.device]
                              + (["--save-ops"] if args.save_ops else [])).returncode

    jobs = [(c, mk) for c in cells for mk in meshes]
    with ThreadPoolExecutor(args.jobs) as pool:
        codes = list(pool.map(one, jobs))
    return 1 if any(codes) else 0


def table(out_dir: str) -> str:
    """The records in `out_dir` as a markdown table, one row a cell: its
    status, argument and temp GB a rank, dot FLOPs a rank, collective GB
    a rank (result bytes, then bytes sent) and trace seconds, with the
    peak (arguments + temp) flagged past 80 GB."""
    rows = ["| arch | shape | mesh | status | args GB | temp GB | peak > 80 GB | "
            "dot FLOPs | coll GB (result) | coll GB (sent) | trace s |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json") or name.endswith(".ops.json"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} |"
        if r["status"] != "ok":
            rows.append(head + f" {r.get('reason') or r.get('error', '')} |" + " |" * 6)
            continue
        m, c = r["memory"], r["collectives"]
        peak = (m["argument_bytes"] + m["temp_bytes"]) / 1e9
        rows.append(head + f" {m['argument_bytes'] / 1e9:.3f} | {m['temp_bytes'] / 1e9:.3f} "
                    f"| {'**yes**' if peak > 80 else 'no'} | {r['cost']['flops']:.4e} | "
                    f"{c['total_bytes'] / 1e9:.3f} | {c['traffic'] / 1e9:.3f} | "
                    f"{r['trace_s']} |")
    return "\n".join(rows)


if __name__ == "__main__":
    sys.exit(main())
