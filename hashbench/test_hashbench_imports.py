"""What a run and the reference load: compared by whole top-level module
names, JAX and the JAX package (`repro`) never; the program (`repro_torch`)
in a run, never in the reference. Both in one fresh process, the
reference first."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from hashbench.conftest import tiny_traffic

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

CHECK = """
import json, sys
from pathlib import Path
sys.path[0] = '.'
import numpy as np, torch
from hashbench.reference import gf_multilinear, keys, multilinear, probes
km = torch.from_numpy(keys.key_matrix(5, 2, 6).view(np.int64))
toks = torch.arange(8, dtype=torch.int32).reshape(2, 4)
lens = torch.tensor([4, 2])
for fam in (multilinear, gf_multilinear):
    probes.mod_u64(fam.surface(toks, lens, km), 1000)
tops = lambda: sorted({m.split('.')[0] for m in sys.modules})
reference = tops()
from hashbench.harness import main
rc = main(['--workload', 'ml_bloom1e8.keys', '--seed', '3000000037', '--seconds', '1'],
          root=Path(sys.argv[1]), device='cpu')
print(json.dumps({"reference": reference, "run": tops()}), file=sys.stderr)
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """One fresh process: the reference alone, then a `--seconds 1` run of
    a tiny cell on the CPU (its traffic file cut to a tiny pool). Gives the
    top-level names each left loaded, and the run's standard output."""
    tmp = tmp_path_factory.mktemp("cell")
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    shutil.copytree(ROOT / "hashbench" / "configs", tmp / "hashbench" / "configs")
    (tmp / "hashbench" / "traffic").mkdir()
    (tmp / "hashbench" / "traffic" / "keys.json").write_text(
        json.dumps(tiny_traffic("keys")))
    p = subprocess.run([sys.executable, "-c", CHECK, str(tmp)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = json.loads(p.stderr.strip().splitlines()[-1])
    return {k: set(v) for k, v in tops.items()}, p.stdout


def test_run_loads_no_jax(loaded):
    """No JAX in the run, and the line has the contract's keys."""
    tops, stdout = loaded
    assert not tops["run"] & FORBIDDEN and "repro_torch" in tops["run"]
    line = json.loads(stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"]


def test_reference_loads_no_program(loaded):
    tops, _ = loaded
    assert not tops["reference"] & (FORBIDDEN | {"repro_torch"})
