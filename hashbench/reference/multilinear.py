"""Multilinear (Lemire & Kaser 2012, Eq. 1) with 64-bit keys, plain.

acc = m1 + sum_i key[1 + i] * s_i mod 2^64 over the row's string with its
sentinel; the 64-bit surface is acc, the 32-bit hash acc >> 32. int64
multiplies and sums wrap mod 2^64, the ring of the accumulator.
"""
from __future__ import annotations

import torch

from .common import MASK32, terminated


def surface(tokens, lengths, keys) -> torch.Tensor:
    """(R, N) tokens, (R,) lengths, (K, >= N + 2) int64 keys holding u64
    bits -> (R, K) int64 holding each row's K accumulators."""
    tok = terminated(tokens, lengths)
    cols = tok.shape[1]
    out = torch.empty((tok.shape[0], keys.shape[0]), dtype=torch.int64,
                      device=tok.device)
    for k in range(keys.shape[0]):
        out[:, k] = (tok * keys[k, 1:cols + 1]).sum(dim=1) + keys[k, 0]
    return out


def hash32(tokens, lengths, keys) -> torch.Tensor:
    """(R, K) int64 32-bit hashes: the accumulator's top half."""
    return (surface(tokens, lengths, keys) >> 32) & MASK32
