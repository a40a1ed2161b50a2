"""Attention: GQA with flash-style chunked softmax, sliding windows (gemma3
local:global), and KV caches (linear + ring-buffer).

The port of `repro.models.attention` in plain PyTorch operations (the
reference has no Pallas here: its `flash_attention` is a `lax.scan` in
jnp). The numerics are the reference's: scores and accumulators in f32,
its internal padding to chunk multiples with the `kv_len` mask, the GQA
repeat per kv chunk. Memory: prefill never materializes (Tq, Tk) scores,
only (B, H, Tq, Ck) per kv chunk.

Caches are updated IN PLACE (`cache_insert`, `ring_prefill`,
`linear_prefill` write into the tensors they are given and return the same
dict); the reference returns new arrays. The values are the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..parallel.sharding import constraint, seq_axis
from .layers import init_normal

NEG_INF = -1e30


def attention_init(gen, d_model, n_heads, n_kv, d_head, bias=False,
                   dtype=torch.float32):
    """Projections stored FUSED-2D -- (d_model, H*dh) -- as the reference
    stores them; heads are a view."""
    s = 1.0 / math.sqrt(d_model)
    p = {
        "wq": {"w": init_normal(gen, (d_model, n_heads * d_head), s, dtype)},
        "wk": {"w": init_normal(gen, (d_model, n_kv * d_head), s, dtype)},
        "wv": {"w": init_normal(gen, (d_model, n_kv * d_head), s, dtype)},
        "wo": {"w": init_normal(gen, (n_heads * d_head, d_model),
                                1.0 / math.sqrt(n_heads * d_head), dtype)},
    }
    if bias:
        for key, n in (("wq", n_heads * d_head), ("wk", n_kv * d_head),
                       ("wv", n_kv * d_head), ("wo", d_model)):
            p[key]["b"] = torch.zeros(n, dtype=dtype, device=gen.device)
    return p


def _proj(p, x, dtype):
    y = x @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def q_project(params, x, d_head, dtype=torch.bfloat16):
    """The query alone (cross-attention reads its keys and values from the
    encoder's cache)."""
    B, T, _ = x.shape
    return _proj(params["wq"], x, dtype).reshape(B, T, -1, d_head)


def kv_project(params, x, d_head, dtype=torch.bfloat16):
    """The keys and values alone (the encoder output's, for that cache)."""
    B, T, _ = x.shape
    return (_proj(params["wk"], x, dtype).reshape(B, T, -1, d_head),
            _proj(params["wv"], x, dtype).reshape(B, T, -1, d_head))


def qkv_project(params, x, d_head, dtype=torch.bfloat16):
    return (q_project(params, x, d_head, dtype),
            *kv_project(params, x, d_head, dtype))


def out_project(params, attn_out, dtype=torch.bfloat16):
    B, T = attn_out.shape[:2]
    return _proj(params["wo"], attn_out.reshape(B, T, -1), dtype)


def _chunk_scores_mask(q_pos, k_pos, causal, window, kv_len=None):
    """(Cq, Ck) additive mask from absolute positions."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones(dq.shape[0], dk.shape[1], dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dk <= dq)
    if window is not None:
        ok = ok & ((dq - dk) < window)
    if kv_len is not None:
        ok = ok & (dk < kv_len)  # internal kv padding
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset=0, chunk_q: int = 512, chunk_k: int = 1024):
    """Online-softmax attention. q: (B, Tq, H, dh); k/v: (B, Tk, Hkv, dh).

    Returns (B, Tq, H, dh). Per kv chunk the scores are (B, H, Tq, Ck) in
    f32; every query row is in each chunk's product, as in the reference
    (its `chunk_q` only sets the padding of Tq).
    """
    B, Tq, H, dh = q.shape
    Tk_real, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    chunk_q = min(chunk_q, Tq)
    chunk_k = min(chunk_k, Tk_real)
    # internal padding to chunk multiples (masked out via kv_len / q slice)
    pad_q = (-Tq) % chunk_q
    pad_k = (-Tk_real) % chunk_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    Tq_p, Tk = Tq + pad_q, Tk_real + pad_k
    kv_len = Tk_real if pad_k else None
    scale = 1.0 / math.sqrt(dh)
    # context-parallel layout: q T-sharded over 'model', k/v whole
    q = constraint(q, "batch", seq_axis(Tq_p), None, None)
    k = constraint(k, "batch", None, None, None)
    v = constraint(v, "batch", None, None, None)
    q_pos = q_offset + torch.arange(Tq_p, device=q.device)

    acc = torch.zeros(B, H, Tq_p, dh, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq_p), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, Tq_p, dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk, chunk_k):
        kc, vc = k[:, k0:k0 + chunk_k], v[:, k0:k0 + chunk_k]
        if G > 1:
            kc = kc.repeat_interleave(G, dim=2)
            vc = vc.repeat_interleave(G, dim=2)
        k_pos = k0 + torch.arange(chunk_k, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kc).float() * scale
        s = s + _chunk_scores_mask(q_pos, k_pos, causal, window, kv_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(kc.dtype), vc).float()
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.movedim(1, 2)[:, :Tq]  # (B, Tq, H, dh)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def make_linear_cache(B, S, n_kv, d_head, dtype=torch.bfloat16, device=None,
                      sp_shard=False):
    """Standard cache: {'k','v'} of (B, S, Hkv, dh). sp_shard shards the S
    dim over 'data' (long-context decoding). Cache dicts carry NO metadata
    leaves, so they stack across blocks; ring caches are identified by the
    presence of a 'pos' buffer."""
    shape = (B, S, n_kv, d_head)
    dev = resolve_device(device)
    k = torch.zeros(shape, dtype=dtype, device=dev)
    v = torch.zeros(shape, dtype=dtype, device=dev)
    if sp_shard:
        k = constraint(k, None, "data", None, None)
        v = constraint(v, None, "data", None, None)
    return {"k": k, "v": v}


def make_ring_cache(B, W, n_kv, d_head, dtype=torch.bfloat16, device=None):
    """Sliding-window ring buffer: (B, W, Hkv, dh) + absolute position tags
    (-1 = empty), shared by the batch rows. Invariant: position p lives in
    slot p % W."""
    cache = make_linear_cache(B, W, n_kv, d_head, dtype, device)
    cache["pos"] = torch.full((W,), -1, dtype=torch.int32,
                              device=cache["k"].device)
    return cache


def is_ring(cache) -> bool:
    return "pos" in cache


def cache_insert(cache, k_new, v_new, index: int):
    """Write (B, 1, Hkv, dh) at absolute position `index` (a Python int),
    in place."""
    slot = index % cache["k"].shape[1] if is_ring(cache) else index
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    if is_ring(cache):
        cache["pos"][slot] = index
    return cache


def ring_prefill(cache, k, v, T):
    """Fill a ring cache from a length-T prefill, in place, preserving the
    slot = p % W invariant so later cache_insert() overwrites the oldest
    entry."""
    W = cache["k"].shape[1]
    if T < W:
        linear_prefill(cache, k, v, T)
        slots = torch.arange(W, dtype=torch.int32, device=k.device)
        cache["pos"].copy_(torch.where(slots < T, slots, -1))
        return cache
    # last W positions T-W..T-1; position p -> slot p % W (static roll)
    shift = (T - W) % W
    cache["k"].copy_(torch.roll(k[:, -W:], shift, dims=1))
    cache["v"].copy_(torch.roll(v[:, -W:], shift, dims=1))
    pos = T - W + torch.arange(W, dtype=torch.int32, device=k.device)
    cache["pos"].copy_(torch.roll(pos, shift))
    return cache


def linear_prefill(cache, k, v, T):
    """Positions 0..T-1 from the prefill, zeros past them, in place."""
    for name, new in (("k", k), ("v", v)):
        cache[name][:, :T] = new
        cache[name][:, T:] = 0
    return cache


def decode_attend(cache, q, index: int, window=None):
    """q: (B, 1, H, dh) against the cache at decode position `index`.

    Full softmax over the cache S dim -- O(S) per token. Returns
    (B, 1, H, dh).
    """
    B, _, H, dh = q.shape
    Hkv = cache["k"].shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, 1, Hkv, G, dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, cache["k"]).float() * scale
    if is_ring(cache):
        pos = cache["pos"]  # (W,)
        ok = (pos >= 0) & (pos <= index)
    else:
        pos = torch.arange(cache["k"].shape[1], device=q.device)
        ok = pos <= index
    if window is not None:
        ok = ok & ((index - pos) < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bhgqd", p.to(cache["v"].dtype), cache["v"])
    return out.movedim(3, 1).reshape(B, 1, H, dh)
