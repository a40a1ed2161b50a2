"""Tiny cells for the CPU tests: the real configurations and traffic mixes
with the pool, the rows and the check cut to a size a test run holds."""
import json
from pathlib import Path

import pytest

from hashbench import harness

HERE = Path(__file__).resolve().parent
CELLS = ("ml_bloom1e8.docs", "gf_bloom1e8.docs", "ml_bloom1e8.keys")
TINY = {"batches": 3, "rows": 64, "check": {"batches": 4, "rows": 16}}
TINY_WIDTH = 40  # a mix of sources: rows cut to 40 columns, means by as much


def tiny_traffic(name: str) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t.update(TINY)
    lens = t["lengths"]
    if lens["kind"] == "sources":
        cut = t["max_tokens"] / TINY_WIDTH
        t["max_tokens"] = TINY_WIDTH
        t["lengths"] = dict(lens, max=TINY_WIDTH, sources=[
            dict(s, tokens_B=s["tokens_B"] / cut) for s in lens["sources"]])
    return t


def tiny_cell(name: str) -> harness.Cell:
    import dataclasses

    cell = harness.load_cell(name)
    return dataclasses.replace(cell, traffic=tiny_traffic(name.split(".")[1]))


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
