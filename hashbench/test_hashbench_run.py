"""Whole runs of tiny cells on the CPU: the result's keys, the check, and
the control and each fault a cell can have seen as not correct."""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from hashbench import faults, harness
from hashbench.conftest import CELLS, tiny_cell

ROOT = Path(__file__).resolve().parents[1]
SEED = 3_000_000_029
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_run_line(name, cpu):
    cell = tiny_cell(name)
    res = harness.run_cell(cell, SEED, 0.3, False, cpu, time.perf_counter())
    assert list(res) == KEYS
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"hash_GBps", "setup_s"}
    assert all(c["value"] == 0 == c["limit"] for c in res["checks"].values())
    json.dumps(res)


def test_traced_line(cpu):
    cell = tiny_cell("ml_bloom1e8.keys")
    res = harness.run_cell(cell, SEED, 0.1, True, cpu, time.perf_counter())
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    # the CPU has no device trace: only the host clock's metric is read
    assert set(res["metrics"]) == {"enqueue_us"}


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", ["ml_bloom1e8.docs", "gf_bloom1e8.docs"])
def test_control_and_faults_fail(name, kind, cpu):
    """The timed path broken underneath the harness: `correct` is false.
    A window of no time and 12 calls, so the sample is the seed's alone."""
    cell = tiny_cell(name)
    with faults.plant(kind):
        res = harness.run_cell(cell, SEED, 0, False, cpu, time.perf_counter(),
                               min_calls=12)
    assert not res["correct"]
    assert res["checks"]["probe_mismatches"]["value"] > 0 and res["failed"] > 0


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file():
    """BENCHMARK.json keeps to the benchmark's contract."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["hashbench"] and 1 <= b["run_seconds"] <= 51
    assert (ROOT / b["command"][1]).is_file()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("hashbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "hashbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert (ROOT / "hashbench" / "metrics" / f"{m['name']}.py").is_file()
        layers.add(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for name in list(cells) + list(configs):
        assert NAME.match(name)
    for name in cells:  # every cell: setup_s, another end-to-end, a per-layer
        cell = harness.load_cell(name)
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
    assert len(json.dumps(b)) < 64 * 1024


def test_cli_needs_a_card():
    """Without CUDA the command exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "hashbench/run.py", "--workload",
                        "ml_bloom1e8.keys", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    if p.returncode == 0:
        pytest.skip("a CUDA card is visible here")
    assert p.stdout == "" and "CUDA" in p.stderr


def test_no_program_no_result(tmp_path):
    """In a folder of BENCHMARK.json and hashbench/ alone (no program) a
    run exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hashbench", tmp_path / "hashbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[0] = '.'; from hashbench.harness import main; "
            "sys.exit(main(['--workload', 'ml_bloom1e8.keys', '--seed', '1', "
            "'--seconds', '1'], device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env={"PATH": ""},
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr
