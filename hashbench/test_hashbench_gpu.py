"""A tiny cell through the harness on the card: a sound run is correct,
the control is not. Marked `gpu`; skips where no card is visible (decided
inside the fixture)."""
import time

import pytest
import torch

from hashbench import faults, harness
from hashbench.conftest import CELLS, tiny_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_the_card(name, cuda):
    cell = tiny_cell(name)
    res = harness.run_cell(cell, 3_000_000_041, 0.5, True, cuda, time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    with faults.plant("control"):
        res = harness.run_cell(cell, 3_000_000_043, 0, False, cuda,
                               time.perf_counter(), min_calls=12)
    assert not res["correct"]
