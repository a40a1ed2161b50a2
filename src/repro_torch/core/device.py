"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and a missing card raises instead of
quietly landing on the CPU. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; None is ``cuda``, which must exist.
    The meta device (shapes only) passes too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_tokens(tokens, device) -> torch.Tensor:
    """Tokens as an int32 tensor of u32 bits on `device`."""
    if isinstance(tokens, torch.Tensor):
        if tokens.dtype == torch.uint32:
            tokens = tokens.view(torch.int32)
        if tokens.dtype != torch.int32:
            raise TypeError(f"tokens must be int32 or uint32, got {tokens.dtype}")
        return tokens.to(device)
    arr = np.ascontiguousarray(np.asarray(tokens).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def as_u32_values(x, device) -> torch.Tensor:
    """u32 values (numpy or a tensor of any integer type, bits as u32) as
    int64 in [0, 2^32) on `device`: the port's form of tokens and key
    planes for arithmetic."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        return x.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
    arr = np.asarray(x).astype(np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(device)
