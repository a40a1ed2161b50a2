"""The port stands alone: no JAX and no `repro` module, CUDA by default."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_CHECK = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("loaded", len([m for m in sys.modules if m.startswith("repro_torch")]))
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _CHECK], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 27


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py"])
def test_sources_name_no_jax_or_reference(path):
    text = (ROOT / path).read_text()
    for needle in ("import jax", "from jax", "from repro.", "import repro\n",
                   "from repro import", "from ...repro", "from ..repro"):
        assert needle not in text, (path, needle)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
