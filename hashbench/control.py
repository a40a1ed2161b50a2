"""Read the numbers that decide `correct` on sound runs and under the
control and the planted faults, at a cell's own size, many seeds in one
process (set-up is paid once a seed, not once a process).

    python hashbench/control.py --workload <cell> --seconds 1 \
        --seeds 11 12 13 ... --fault-seeds 21 22 23 --faults control answer half

A cell whose configuration names a runner (a training cell) takes its
faults from `model_faults.py`, the others from `faults.py`.

Prints one JSON line a run ({"kind", "seed", "correct", "checks"}) and, last,
each number's lower reading (the largest over the sound runs) and each
fault's smallest reading. The benchmark's own runs do not run this.
"""
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from hashbench import faults, model_faults  # noqa: E402
from hashbench.harness import load_cell, run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=["control"],
                   choices=sorted(set(faults.KINDS) | set(model_faults.KINDS)))
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    plant = (model_faults if "runner" in cell.config else faults).plant
    keep = cell.traffic["check"]["batches"] if "check" in cell.traffic else 1
    readings: dict = {}
    runs = [("sound", s) for s in args.seeds]
    runs += [(k, s) for k in args.faults for s in args.fault_seeds]
    for kind, seed in runs:
        t0 = time.perf_counter()
        with plant(kind) if kind != "sound" else contextlib.nullcontext():
            res = run_cell(cell, seed, args.seconds, False, device, t0,
                           min_calls=keep,
                           warm_calls=cell.traffic["batches"] if kind == "control" else None)
        line = {"kind": kind, "seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "checks": res["checks"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        for name, c in res["checks"].items():
            readings.setdefault(kind, {}).setdefault(name, []).append(c["value"])
    summary = {"lower": {n: max(v) for n, v in readings.get("sound", {}).items()}}
    for kind in args.faults:
        if kind in readings:
            summary[kind] = {n: min(v) for n, v in readings[kind].items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
