"""A training step's model FLOPs and the table of bf16 peaks.

The count of PaLM (arXiv:2204.02311, App. B), from the configuration
file's widths alone: each token costs 6 FLOPs (forward and backward) a
parameter of every matrix product it passes, plus the attention products
(QK^T and PV) at 6 x layers x heads x head width x T a token, half of
PaLM's 12 for the causal mask. The parameters a token passes are the
q, k, v and o projections, the router, the gate, up and down matrices of
its `num_experts_per_tok` experts in every layer, and the output head
(tied or not: the product runs). The embedding lookup is no product, and
a recompute (remat) is not counted.
"""
from __future__ import annotations

#: Dense bf16 peak of each card by its `torch.cuda.get_device_name()`:
#: NVIDIA's data sheet (H100 SXM, at the full 700 W power limit).
BF16_FLOPS_PER_S = {"NVIDIA H100 80GB HBM3": 989.4e12}


def active_params(cfg: dict) -> int:
    """Matrix-product parameters one token passes."""
    D, H, Hkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = D // H
    attn = D * H * dh + 2 * D * Hkv * dh + H * dh * D
    router = D * cfg["num_local_experts"]
    routed = cfg["num_experts_per_tok"] * 3 * D * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + router + routed) + D * cfg["vocab_size"]


def step_flops(cfg: dict, rows: int, seq_len: int) -> int:
    """Model FLOPs of one step over rows x seq_len tokens."""
    dh = cfg["hidden_size"] // cfg["num_attention_heads"]
    per_token = (6 * active_params(cfg)
                 + 6 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * dh * seq_len)
    return rows * seq_len * per_token

