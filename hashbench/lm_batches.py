"""The generator of packed training batches: a pool made from the seed.

A traffic file of kind `packed` (`traffic/<name>.json`) gives the pool's
shape (`batches` of `rows` x `seq_len` tokens) and the documents'
lengths, in the form `generator.py` reads (`sources`: a corpus's sources,
exponential within each). The documents are laid back to back, each
followed by `eos_id`, and the stream is cut into rows of `seq_len` + 1
tokens: a row's first `seq_len` are its inputs, its last `seq_len` their
labels (the next token). A document that overflows a row goes on in the
next. Every seed gets the same multiset of document lengths (the fewest
quantiles whose stream fills the pool), in an order drawn from the seed;
token ids are uniform below the vocabulary, drawn on the device in one
call.
"""
from __future__ import annotations

import dataclasses

import torch

from hashbench.generator import quantile_lengths


@dataclasses.dataclass
class Pool:
    tokens: torch.Tensor  # (batches, rows, seq_len) int32
    labels: torch.Tensor  # (batches, rows, seq_len) int32
    docs: int             # documents in the pool's stream

    @property
    def batches(self) -> int:
        return self.tokens.shape[0]

    def batch(self, i: int) -> dict:
        return {"tokens": self.tokens[i], "labels": self.labels[i]}


def doc_lengths(traffic: dict) -> torch.Tensor:
    """The fewest documents whose stream (a length and an EOS each) fills
    the pool, as (n,) int64 lengths in no order of the seed."""
    need = traffic["batches"] * traffic["rows"] * (traffic["seq_len"] + 1)
    n = 1
    while int((quantile_lengths(traffic["lengths"], n) + 1).sum()) < need:
        n *= 2
    lo, hi = n // 2, n  # the fewest in (lo, hi]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if int((quantile_lengths(traffic["lengths"], mid) + 1).sum()) >= need:
            hi = mid
        else:
            lo = mid
    return quantile_lengths(traffic["lengths"], hi)


def make_pool(traffic: dict, vocab: int, seed: int, device) -> Pool:
    """The traffic's pool on `device`, from `seed`."""
    if traffic.get("kind") != "packed":
        raise ValueError(f"not a packed traffic mix: {traffic.get('kind')!r}")
    P, B, T = traffic["batches"], traffic["rows"], traffic["seq_len"]
    eos = traffic["eos_id"]
    if not 0 <= eos < vocab:
        raise ValueError(f"eos_id {eos} lies outside the vocabulary of {vocab}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lens = doc_lengths(traffic).to(device)
    lens = lens[torch.randperm(len(lens), generator=gen, device=device)]
    n = P * B * (T + 1)
    stream = torch.randint(0, vocab, (n,), generator=gen, dtype=torch.int32,
                           device=device)
    ends = torch.cumsum(lens + 1, 0) - 1  # each document's EOS
    stream[ends[ends < n]] = eos
    rows = stream.view(P, B, T + 1)
    return Pool(rows[..., :-1].contiguous(), rows[..., 1:].contiguous(), len(lens))
