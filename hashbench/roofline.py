"""The least time of a probe call by its bytes, and the table of peaks.

A frozen copy of the byte count of `chip_smoke.py` (`live_work`,
`probe_bound`), for variable-length rows: what the inputs need, each byte
read or written once, whatever the engine reads again or pads to.
"""
from __future__ import annotations

import numpy as np

#: Memory rate of each card by its `torch.cuda.get_device_name()`: NVIDIA's
#: data sheet (H100 SXM, 80 GB HBM3, at the full 700 W power limit). The
#: data sheet gives no integer CUDA-core peak, so the share is by bytes.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def live_tokens(lengths, N: int) -> int:
    """Tokens inside the rows' lengths, no row past its N columns (a row's
    sentinel is made, not loaded)."""
    return int(np.minimum(np.asarray(lengths, np.int64), N).sum())


def probe_call_bytes(lengths, N: int, K: int, key_bytes: int) -> int:
    """Bytes one `probe_indices` call over these rows needs: the live
    tokens (4 bytes each), K keys of `key_bytes` for each column the
    longest row hashes (its tokens, the sentinel) and m1, one 4-byte
    length a row, read once; K u32 residues a row (each < m < 2^32)
    written once."""
    lens = np.asarray(lengths, np.int64)
    B = len(lens)
    cols = int(np.minimum(lens, N).max(initial=0)) + 2
    return 4 * live_tokens(lens, N) + K * cols * key_bytes + 4 * B + 4 * B * K


def least_seconds(nbytes: int, kind: str) -> "float | None":
    """nbytes over the memory rate of card `kind`; None for a card the
    table does not hold."""
    rate = HBM_BYTES_PER_S.get(kind)
    return None if rate is None else nbytes / rate
