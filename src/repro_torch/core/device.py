"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and a missing card raises instead of
quietly landing on the CPU. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; None is ``cuda``, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
