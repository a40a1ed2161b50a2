"""The control and the faults, planted under the timed path.

Each replaces `Hasher.probe_indices` of the program for the length of a
`with plant(kind):` block, so the harness runs unchanged above it:

- control: the reference in the program's place, one step down in width:
  probes from the 32-bit hash (h32 mod m) where the configuration states
  the 64-bit surface (out_bits 64);
- answer: the program's answers with each row's first probe moved by one;
- token: each row's first token altered where it enters the hash;
- half: only the first half of each batch hashed, the rest left at 0;
- stale: every call hands back the first call's answers (the state left
  unchanged).
"""
from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from hashbench.harness import REF_BLOCK_ROWS, program
from hashbench.reference import keys as ref_keys
from hashbench.reference import probes as ref_probes

KINDS = ("control", "answer", "token", "half", "stale")


def _control(self, tokens, plan, lengths=None):
    spec = self.spec
    family = importlib.import_module(f"hashbench.reference.{spec.family}")
    keys = torch.from_numpy(ref_keys.key_matrix(
        spec.seed, spec.n_hashes, tokens.shape[-1] + 2).view(np.int64)).to(tokens.device)
    out = [ref_probes.mod_u64(family.hash32(tokens[r:r + REF_BLOCK_ROWS],
                                            lengths[r:r + REF_BLOCK_ROWS], keys), plan)
           for r in range(0, tokens.shape[0], REF_BLOCK_ROWS)]
    return torch.cat(out)


@contextlib.contextmanager
def plant(kind: str):
    """Within the block, the program's `probe_indices` carries `kind`."""
    Hasher = program()[0]
    sound = Hasher.probe_indices
    first = {}

    def broken(self, tokens, plan, lengths=None):
        if kind == "control":
            return _control(self, tokens, plan, lengths)
        if kind == "token":
            tokens = tokens.clone()
            tokens[:, 0] ^= 1
        if kind == "half":
            half = tokens.shape[0] // 2
            out = torch.zeros((tokens.shape[0], self.spec.n_hashes),
                              dtype=torch.int64, device=tokens.device)
            out[:half] = sound(self, tokens[:half], plan, lengths[:half])
            return out
        out = sound(self, tokens, plan, lengths)
        if kind == "answer":
            out = out.clone()
            out[:, 0] = (out[:, 0] + 1) % plan
        if kind == "stale":
            return first.setdefault("out", out)
        return out

    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; have {KINDS}")
    Hasher.probe_indices = broken
    try:
        yield
    finally:
        Hasher.probe_indices = sound
