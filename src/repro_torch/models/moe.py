"""Mixture-of-Experts: top-k routing, capacity-factor grouped dispatch, the
expert FFN and a hash-router option.

The port of `repro.models.moe` in plain PyTorch operations (the reference's
is jnp, no Pallas). Tokens (B, T, D) become G groups of n = B*T/G; within a
group each (token, choice) pair takes the next slot of its expert, ranked
by a one-hot cumsum in token-major order, into a capacity buffer (G, E, C,
D); pairs past capacity C drop (they add nothing). The expert FFN is
batched products over (G, E, C, D); the combine adds each token's expert
outputs, times its gates, back into (G, n, D).

Routers:
  - 'learned': softmax router (f32) + the Switch load-balance loss. The
    top-k is `torch.topk`, which does not promise the order of tied
    probabilities on CUDA (`jax.lax.top_k` puts the lower index first);
    f32 router probabilities tie with negligible probability.
  - 'hash': Roller et al. hash layers with the paper's MULTILINEAR family:
    expert j of a token is h_j(token_id) % E for k independent keyed
    hashes (plain int64 tensor arithmetic, as the reference computes it
    in-graph). Strong universality gives per-pair collision 1/E and
    uniform expected load with no balance loss. The k hashes are
    independent, so a token may pick one expert twice; it then takes two
    slots of it.

The combine order is deterministic and the reference's: its scatter-add
adds the k contributions of a token into a zero row in flat (E, C) slot
order, rounding after each add in the compute dtype; here each token's
contributions are sorted by flat slot index and added in that order (no
atomics, so a bf16 result does not vary run to run).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.keys import KeyBuffer
from . import layers
from .layers import MASK32, init_normal


def _expert_normal(gen, shape, scale, dtype):
    """`init_normal` of an (E, ...) stack, drawn one expert at a time so a
    large stack never exists in f32 (llama4's (128, 5,120, 8,192) would be
    21 GB)."""
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        w[e] = init_normal(gen, shape[1:], scale, dtype)
    return w


def hash_router_keys(n_experts: int, device) -> dict:
    """The hash router's key planes: the reference's `KeyBuffer(seed=0x40E +
    n_experts).u64(34)` (up to 16 hashes: (m1, m2) pairs), as int64 tensors
    of u32 values."""
    keys = KeyBuffer(seed=0x40E + n_experts).u64(34)
    return {"const_hash_hi": torch.from_numpy(
                (keys >> np.uint64(32)).astype(np.int64)).to(device),
            "const_hash_lo": torch.from_numpy(
                (keys & np.uint64(MASK32)).astype(np.int64)).to(device)}


def moe_init(gen, d_model, d_ff, n_experts, *, router="learned",
             shared_expert=False, act="swiglu", dtype=torch.float32):
    """Expert matrices in `dtype` (the reference casts them at use); the
    learned router's matrix in f32 (the reference uses it uncast)."""
    s = 1.0 / math.sqrt(d_model)
    E = n_experts
    p = {"w_up": {"w": _expert_normal(gen, (E, d_model, d_ff), s, dtype)},
         "w_down": {"w": _expert_normal(gen, (E, d_ff, d_model),
                                        1.0 / math.sqrt(d_ff), dtype)}}
    if act == "swiglu":
        p["w_gate"] = {"w": _expert_normal(gen, (E, d_model, d_ff), s, dtype)}
    if router == "learned":
        p["router"] = {"w": init_normal(gen, (d_model, E), s, torch.float32)}
    else:
        p.update(hash_router_keys(E, gen.device))
    if shared_expert:
        p["shared"] = layers.mlp_init(gen, d_model, d_ff, act=act, dtype=dtype)
    return p


def _hash_route(params, token_ids, n_experts, k):
    """k independent MULTILINEAR hashes of token ids -> (N, k) expert ids."""
    return layers.token_hashes(params["const_hash_hi"], params["const_hash_lo"],
                               token_ids.reshape(-1), n_experts, k)


def capacity_of(n: int, k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert has in a group of n tokens (the reference's rule)."""
    return max(k, int(math.ceil(n * k / n_experts * capacity_factor)))


def _group_dispatch(idx, n_experts, capacity):
    """idx (G, n, k) expert ids -> (G, n, k) slot of each pair within its
    expert, ranked in token-major order; `capacity` (the sentinel) where
    the pair drops."""
    G, n, k = idx.shape
    flat_e = idx.reshape(G, n * k)
    oh = torch.nn.functional.one_hot(flat_e, n_experts)           # (G, n*k, E)
    ranks = oh.cumsum(dim=1) - 1                                   # rank within expert
    slot = ranks.gather(2, flat_e[..., None])[..., 0]
    return torch.where(slot < capacity, slot, capacity).reshape(G, n, k)


def _dispatch(xg, idx, slot, n_experts, capacity):
    """xg (G, n, D) -> the capacity buffer (G, E, C, D): pair (t, j) writes
    token t at (idx, slot); dropped pairs write a sentinel row that is cut
    off (every real slot is written at most once)."""
    G, n, D = xg.shape
    buf = xg.new_zeros(G, n_experts * (capacity + 1), D)
    flat = idx * (capacity + 1) + slot                             # (G, n, k)
    rows = torch.arange(G, device=xg.device)[:, None]
    for j in range(idx.shape[-1]):
        buf[rows, flat[..., j]] = xg
    return buf.view(G, n_experts, capacity + 1, D)[:, :, :capacity]


def _combine(out_buf, idx, slot, gate, capacity):
    """(G, E, C, D) expert outputs -> (G, n, D): each token's kept
    contributions out_buf[e, c] * gate, added to a zero row in increasing
    flat slot order e*C + c (the reference's scatter-add order)."""
    G, E, C, D = out_buf.shape
    flat = torch.where(slot < capacity, idx * C + slot, E * C)     # E*C: dropped
    flat, order = flat.sort(dim=-1, stable=True)
    gate = gate.gather(-1, order)
    src = torch.cat([out_buf.reshape(G, E * C, D),
                     out_buf.new_zeros(G, 1, D)], dim=1)           # a zero row for drops
    rows = torch.arange(G, device=out_buf.device)[:, None]
    y = out_buf.new_zeros(G, idx.shape[1], D)
    for j in range(idx.shape[-1]):
        y = y + src[rows, flat[..., j]] * gate[..., j, None]
    return y


def moe_apply(params, x, *, n_experts, k, capacity_factor=1.25, groups=None,
              router="learned", token_ids=None, act="swiglu",
              dtype=torch.bfloat16):
    """x: (B, T, D) -> (B, T, D), plus aux dict (load-balance loss)."""
    B, T, D = x.shape
    N = B * T
    G = groups or 1
    if N % G:
        raise ValueError(f"{N} tokens do not split into {G} MoE groups")
    n = N // G
    capacity = capacity_of(n, k, n_experts, capacity_factor)
    xf = x.reshape(N, D)
    aux = {}
    if router == "hash":
        if token_ids is None:
            raise ValueError("the hash router needs token ids")
        idx = _hash_route(params, token_ids, n_experts, k)            # (N, k)
        gate = torch.full((N, k), 1.0 / k, dtype=dtype, device=x.device)
        aux["balance_loss"] = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        logits = xf.float() @ params["router"]["w"]                   # (N, E) f32
        probs = torch.softmax(logits, dim=-1)
        gate_f, idx = torch.topk(probs, k, dim=-1)
        gate = (gate_f / gate_f.sum(-1, keepdim=True).clamp_min(1e-9)).to(dtype)
        # Switch aux loss: E * sum_e f_e p_e
        me = torch.nn.functional.one_hot(idx[:, 0], n_experts).float().mean(0)
        pe = probs.mean(0)
        aux["balance_loss"] = n_experts * (me * pe).sum()

    xg = xf.reshape(G, n, D)
    idx = idx.reshape(G, n, k)
    gate = gate.reshape(G, n, k)
    slot = _group_dispatch(idx, n_experts, capacity)
    buf = _dispatch(xg, idx, slot, n_experts, capacity)               # (G, E, C, D)

    up = torch.einsum("gecd,edf->gecf", buf, params["w_up"]["w"].to(dtype))
    if act == "swiglu":
        h = layers._silu(torch.einsum("gecd,edf->gecf", buf,
                                      params["w_gate"]["w"].to(dtype))) * up
    else:
        h = layers._gelu(up)
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"]["w"].to(dtype))
    y = _combine(out_buf, idx, slot, gate, capacity).reshape(B, T, D)
    if "shared" in params:
        y = y + layers.mlp(params["shared"], x, act=act, dtype=dtype)
    return y, aux
