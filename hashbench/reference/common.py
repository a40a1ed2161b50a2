"""What the family modules share: the variable-length rule."""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def terminated(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(R, N) int32 tokens holding u32 bits and (R,) lengths -> (R, N + 1)
    int64: token i where i < L, the sentinel 1 at position L, 0 after it
    (the paper's append-1 rule for strings of variable length; whatever a
    row holds past its length is not part of the string)."""
    R, N = tokens.shape
    tok = torch.zeros((R, N + 1), dtype=torch.int64, device=tokens.device)
    tok[:, :N] = tokens.to(torch.int64) & MASK32
    col = torch.arange(N + 1, device=tokens.device)[None, :]
    L = lengths.to(device=tokens.device, dtype=torch.int64)[:, None]
    return torch.where(col < L, tok, (col == L).to(torch.int64))
