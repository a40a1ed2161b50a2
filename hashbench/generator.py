"""The general traffic generator: a pool of batches made from the seed.

A traffic file (`traffic/<name>.json`) gives the pool's shape and the
row lengths; this module makes the pool on the run's device:

- lengths: every seed gets the same multiset of row lengths, in an order
  drawn from the seed (so a seed changes which row is long, not how much
  work there is). `sources`: a corpus's sources, each given as the
  documents and tokens of a published table; a source gets the pool's rows
  in its share of the documents, and its lengths are the quantiles at
  (i + 1/2) / n of an exponential with the source's mean tokens a document
  (the table gives means only: the exponential assumes nothing more),
  rounded and clipped to [min, max]. `fixed`: every row `tokens` long;
- tokens: uniform ids below `vocab` in every column, past a row's length
  too (a reused buffer holds stale ids there; the string ends at its
  length), in one call on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Pool:
    tokens: torch.Tensor      # (batches, rows, N) int32
    lengths: torch.Tensor     # (batches, rows) int32, on the device
    lengths_host: np.ndarray  # the same, on the host

    @property
    def batches(self) -> int:
        return self.tokens.shape[0]


def bounds(dist: dict) -> tuple:
    """The least and the greatest length the distribution gives."""
    if dist["kind"] == "fixed":
        return dist["tokens"], dist["tokens"]
    return dist["min"], dist["max"]


def source_rows(sources: list, n: int) -> np.ndarray:
    """Rows of n for each source, in its share of the documents (largest
    remainders)."""
    docs = np.array([s["documents_M"] for s in sources], np.float64)
    exact = n * docs / docs.sum()
    rows = np.floor(exact).astype(np.int64)
    rows[np.argsort(rows - exact, kind="stable")[:n - rows.sum()]] += 1
    return rows


def quantile_lengths(dist: dict, n: int) -> torch.Tensor:
    """(n,) int64 lengths on the CPU, in no order of the seed."""
    if dist["kind"] == "fixed":
        return torch.full((n,), dist["tokens"], dtype=torch.int64)
    if dist["kind"] != "sources":
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    parts = []
    for s, k in zip(dist["sources"], source_rows(dist["sources"], n)):
        mean = 1e3 * s["tokens_B"] / s["documents_M"]
        p = (torch.arange(int(k), dtype=torch.float64) + 0.5) / max(1, int(k))
        parts.append(-mean * torch.log1p(-p))
    x = torch.cat(parts)
    return torch.round(x).clamp(dist["min"], dist["max"]).to(torch.int64)


def make_pool(traffic: dict, seed: int, device) -> Pool:
    """The traffic's pool of batches on `device`, from `seed`."""
    P, B, N = traffic["batches"], traffic["rows"], traffic["max_tokens"]
    lo, hi = bounds(traffic["lengths"])
    if hi > N or lo < 0:
        raise ValueError("lengths must lie in [0, max_tokens]")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lens = quantile_lengths(traffic["lengths"], P * B).to(device)
    lens = lens[torch.randperm(P * B, generator=gen, device=device)]
    lens = lens.reshape(P, B).to(torch.int32)
    tokens = torch.randint(0, traffic["vocab"], (P, B, N), generator=gen,
                           dtype=torch.int32, device=device)
    return Pool(tokens, lens, lens.cpu().numpy())
